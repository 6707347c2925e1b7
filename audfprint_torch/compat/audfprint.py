"""Reference audfprint.py surface: the CLI."""

from audfprint_torch.cli import (  # noqa: F401
    filename_list_iterator,
    main,
    setup_analyzer,
    setup_matcher,
)
