"""Synthetic datasets + groundtruth generation.

The counterpart of ``vaq_tpu/data.py``. ``make_anisotropic_gaussian`` is pure
numpy and copied unchanged, so both packages build identical datasets from a
seed; ``make_sift_like`` takes its groundtruth from this package's exact
search, on the device it is given.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vaq_tpu_torch.ops.distances import compute_groundtruth


def make_anisotropic_gaussian(
    n: int,
    d: int,
    n_queries: int,
    seed: int = 0,
    n_clusters: int = 64,
    decay: float = 0.95,
) -> Tuple[np.ndarray, np.ndarray]:
    """Clustered data with geometrically decaying per-dim variance.

    The decay gives a skewed PCA spectrum like real SIFT/GIST descriptors, so
    VAQ's non-uniform bit allocation behaves as it does on the paper datasets.
    Queries are perturbed database points (realistic NN structure).
    """
    rng = np.random.default_rng(seed)
    scales = decay ** np.arange(d)
    mix = rng.standard_normal((d, d)).astype(np.float32) / np.sqrt(d)

    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 2.0
    assign = rng.integers(0, n_clusters, size=n)
    base = centers[assign] + (
        rng.standard_normal((n, d)).astype(np.float32) * scales[None, :]
    )
    base = base @ mix  # rotate so variance structure isn't axis-aligned

    q_src = rng.integers(0, n, size=n_queries)
    queries = base[q_src] + 0.05 * rng.standard_normal((n_queries, d)).astype(
        np.float32
    )
    return base.astype(np.float32), queries.astype(np.float32)


def make_sift_like(n: int = 10000, n_queries: int = 100, d: int = 128,
                   seed: int = 42, device: torch.device | str = "cpu",
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(base, queries, groundtruth@100) — the siftsmall-shaped fixture."""
    base, queries = make_anisotropic_gaussian(n, d, n_queries, seed)
    gt = compute_groundtruth(queries, base, k=100, device=device)
    return base, queries, gt
