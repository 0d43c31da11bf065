"""Intercept-aware prefix KV cache: radix-tree sharing over refcounted
copy-on-write pages (DESIGN.md §8)."""
from repro_torch.cache.prefix_tree import (CacheStats, Match,  # noqa: F401
                                     PrefixCache)
