"""Reference hash_table.py surface."""

from audfprint_torch.index.hash_table import HashTable  # noqa: F401
