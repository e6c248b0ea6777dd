"""Deterministic sampling utilities.

Copied verbatim from ``vaq_tpu/rng.py``: importing it from there would
run ``vaq_tpu/__init__.py``, which imports jax, and this package never does.

The reference derives all training-time sampling from a Fisher–Yates
permutation with a fixed mt19937 seed (``utils/Random.hpp:7-48``, seed
13517106), which makes runs bit-reproducible. We keep the same structure —
every sampling site takes an explicit seed and goes through
:func:`random_permutation` — using numpy's PCG64; parity with the C++ stream
is not required (recall parity is defined on result quality, SURVEY §7.5).
"""

from __future__ import annotations

import numpy as np

DEFAULT_SEED = 13517106  # reference Random.hpp:15


def random_permutation(n: int, seed: int = DEFAULT_SEED) -> np.ndarray:
    """Permutation of [0, n) (reference randomPermutation, Random.hpp:18-28)."""
    rng = np.random.default_rng(seed)
    return rng.permutation(n)


def sample_rows(x: np.ndarray, sample_size: int, seed: int = DEFAULT_SEED) -> np.ndarray:
    """First `sample_size` rows of a seeded permutation of x's rows.

    This is the reference's universal sampling idiom (e.g. VAQ.cpp:16-25 for
    the covariance sample, VAQ.cpp:535-544 for codebook training — where we
    also fix the reference's bug of leaving the slice uninitialized when
    sample_size < rows, SURVEY §2.1 V6).
    """
    n = x.shape[0]
    if sample_size >= n:
        return x
    perm = random_permutation(n, seed)[:sample_size]
    return x[perm]
