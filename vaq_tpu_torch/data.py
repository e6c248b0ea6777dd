"""Synthetic datasets + groundtruth generation.

The counterpart of ``vaq_tpu/data.py``. ``make_anisotropic_gaussian`` is pure
numpy and copied unchanged, so both packages build identical datasets from a
seed; ``make_sift_like`` takes its groundtruth from this package's exact
search, on the device it is given. ``DeviceChunkSource`` (data.py:76-142)
generates a 100M-row dataset chunk by chunk on the device, with the same
mixture model; its rows come from torch's generator, not JAX's, so they are
not the JAX source's rows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vaq_tpu_torch.device import DEFAULT, resolve
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
                   seed: int = 42, device: torch.device | str = DEFAULT,
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(base, queries, groundtruth@100) — the siftsmall-shaped fixture; the
    groundtruth is computed on ``device``."""
    dev = resolve(device)
    base, queries = make_anisotropic_gaussian(n, d, n_queries, seed)
    gt = compute_groundtruth(queries, base, k=100, device=dev)
    return base, queries, gt


def _stream_seed(*key: int) -> int:
    """A 64-bit generator seed for one stream, hashed from its integer key
    by numpy's SeedSequence (keys of different lengths give unrelated
    seeds)."""
    return int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0])


class DeviceChunkSource:
    """Chunked DEEP-like dataset generated on the device (JAX
    ``DeviceChunkSource``, vaq_tpu/data.py:76-142).

    At 100M × 96 the raw dataset is 38 GB; it never exists whole. Chunk
    ``i`` is a pure function of ``(seed, i)`` and can be generated again at
    any time: the device-side analog of re-reading a chunk from disk in the
    reference's disk-resident scan (``BitVecEngine.cpp:1441-1624``). Encode,
    exact groundtruth, refine and the streamed probe build each stream the
    chunks with O(chunk) device transients.

    The mixture's host parameters (per-dimension ``scales``, the rotation
    ``mix`` and the cluster ``centers``) are drawn from
    ``np.random.default_rng(seed)`` exactly as the JAX source draws them,
    so they equal JAX's bit for bit. The rows do not: chunk ``i`` draws its
    cluster assignments (``randint``) and its noise (``randn``) from a
    ``torch.Generator`` on the source's device seeded from ``(seed, i)``,
    where JAX folds ``i`` into its own PRNG key; the product with ``mix``
    is a full-f32 matmul, as JAX's ``preferred_element_type=f32``. The
    queries' stream is seeded apart from every chunk's."""

    def __init__(self, n: int, d: int, chunk_rows: int = 2_000_000,
                 seed: int = 42, n_clusters: int = 64, decay: float = 0.95,
                 device: torch.device | str = DEFAULT):
        self.device = resolve(device)
        self.n = n
        self.d = d
        self.chunk_rows = min(chunk_rows, n)
        self.seed = seed
        self.n_chunks = -(-n // self.chunk_rows)
        host = np.random.default_rng(seed)
        self.scales = (decay ** np.arange(d)).astype(np.float32)
        # f32 / a numpy f64 scalar is f64 (NEP 50): JAX's jnp.asarray
        # rounds it back to f32, and so does this
        self.mix = (host.standard_normal((d, d)).astype(np.float32)
                    / np.sqrt(d)).astype(np.float32)
        self.centers = (host.standard_normal((n_clusters, d)) * 2.0).astype(
            np.float32)
        self._centers = torch.as_tensor(self.centers, device=self.device)
        self._scales = torch.as_tensor(self.scales, device=self.device)
        self._mix = torch.as_tensor(self.mix, device=self.device)

    def _generator(self, *key: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_stream_seed(self.seed, *key))
        return gen

    def chunk(self, i: int) -> torch.Tensor:
        """(rows_i, d) f32 chunk on the device; the last chunk may be
        short."""
        if not 0 <= i < self.n_chunks:
            raise IndexError(f"chunk {i} out of {self.n_chunks}")
        rows = min(self.chunk_rows, self.n - i * self.chunk_rows)
        gen = self._generator(0, i)
        assign = torch.randint(0, self._centers.shape[0], (rows,),
                               generator=gen, device=self.device)
        noise = torch.randn((rows, self.d), generator=gen,
                            device=self.device)
        return (self._centers[assign] + noise * self._scales[None, :]) @ \
            self._mix

    def chunks(self):
        for i in range(self.n_chunks):
            yield self.chunk(i)

    def queries(self, n_queries: int, noise: float = 0.05) -> np.ndarray:
        """Perturbed rows of chunk 0 (realistic NN structure), as host f32."""
        c0 = self.chunk(0)
        gen = self._generator(1)
        idx = torch.randint(0, c0.shape[0], (n_queries,), generator=gen,
                            device=self.device)
        q = c0[idx] + noise * torch.randn((n_queries, self.d), generator=gen,
                                          device=self.device)
        return q.cpu().numpy().astype(np.float32)

    def host_sample(self, n_sample: int, seed: int = 0) -> np.ndarray:
        """A host-side row sample for train(): rows drawn uniformly across
        chunks by numpy (JAX's draw), one device gather per touched chunk."""
        rng = np.random.default_rng(self.seed + seed)
        take = np.sort(rng.choice(self.n, size=min(n_sample, self.n),
                                  replace=False))
        parts = []
        for i in range(self.n_chunks):
            lo = i * self.chunk_rows
            sel = take[(take >= lo) & (take < lo + self.chunk_rows)] - lo
            if sel.size:
                parts.append(self.chunk(i)[torch.as_tensor(
                    sel, device=self.device)].cpu().numpy())
        return np.concatenate(parts, axis=0)
