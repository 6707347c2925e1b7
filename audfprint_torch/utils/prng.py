"""Deterministic keyed PRNG for reservoir-sampled hash-table stores.

The reference uses Python's global `random.randint(0, count)` for the
reservoir overwrite slot (hash_table.py:~150, SURVEY §2.3.4), which makes
ingest order- and process-dependent.  Per SURVEY §7 ("Hard parts"), this
rebuild replaces it with a *deterministic* PRNG keyed by
(bucket, insertion position, seed) so that:

  * ingest is reproducible run-to-run,
  * the sequential host store and the vectorized on-device store agree
    bit-for-bit,
  * sharded ingest is shard-order-independent.

Behavior below the bucket-overflow point (counts < depth) is identical to the
reference (randomness never engages there).  The mixer is the murmur3/
splitmix-style 32-bit finalizer — implementable identically in NumPy and JAX
uint32 arithmetic.
"""

from __future__ import annotations

import numpy as np

_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_GOLDEN = np.uint32(0x9E3779B1)


def mix32(x):
    """Murmur3 fmix32 finalizer over uint32 (NumPy version)."""
    with np.errstate(over="ignore"):
        x = np.asarray(x, dtype=np.uint32)
        x = x ^ (x >> np.uint32(16))
        x = (x * _C1).astype(np.uint32)
        x = x ^ (x >> np.uint32(13))
        x = (x * _C2).astype(np.uint32)
        x = x ^ (x >> np.uint32(16))
    return x


def reservoir_slot(bucket, position, seed=0):
    """Slot in [0, position] for the entry being inserted at `position`
    (0-based insertion index) into `bucket`.  position >= depth callers only.

    Uniform over [0, position] via mix32 modulo (position+1); the modulo bias
    is negligible for position+1 << 2^32.
    """
    with np.errstate(over="ignore"):
        bucket = np.asarray(bucket, dtype=np.uint32)
        position = np.asarray(position, dtype=np.uint32)
        h = mix32((bucket * _GOLDEN).astype(np.uint32)
                  ^ mix32(position + np.uint32(seed)))
        return (h % (position + np.uint32(1))).astype(np.int64)
