"""Reference audfprint_match.py surface."""

from audfprint_torch.match.matcher import Matcher  # noqa: F401
from audfprint_torch.oracle.analyze import locmax  # noqa: F401
from audfprint_torch.oracle.match import find_modes  # noqa: F401
