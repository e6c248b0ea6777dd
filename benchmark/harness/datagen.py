"""Rows and queries made on the device from ``--seed``.

A torch copy of the repository's mixture model (``make_anisotropic_gaussian``
of ``vaq_tpu_torch/data.py``): 64 cluster centres of scale 2, per-dimension
noise decaying as 0.95**i, one random rotation, queries = base rows + 0.05
noise. Everything is drawn from one ``torch.Generator`` on the device, in a
few large calls, so the same seed on the same card gives the same tensors and
the reference can make them again after the window.
"""

from __future__ import annotations

import numpy as np
import torch

N_CLUSTERS = 64
DECAY = 0.95
QUERY_NOISE = 0.05
_CHUNK = 1 << 21


def stream_seed(seed: int, stream: int) -> int:
    """A 64-bit generator seed for one stream of a run's seed (any whole
    number; negative and large ones included)."""
    return int(np.random.SeedSequence([seed % (1 << 64), stream])
               .generate_state(1, np.uint64)[0])


def generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return gen


@torch.no_grad()
def make_rows(n: int, d: int, n_queries: int, seed: int, device
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(base (n, d) f32, queries (n_queries, d) f32), both on ``device``."""
    gen = generator(seed, 0, device)
    scales = DECAY ** torch.arange(d, dtype=torch.float32, device=device)
    mix = torch.randn((d, d), generator=gen, device=device) / np.sqrt(d)
    centers = torch.randn((N_CLUSTERS, d), generator=gen, device=device) * 2.0
    assign = torch.randint(0, N_CLUSTERS, (n,), generator=gen, device=device)
    noise = torch.randn((n, d), generator=gen, device=device)
    base = torch.empty((n, d), dtype=torch.float32, device=device)
    for s in range(0, n, _CHUNK):
        blk = noise[s:s + _CHUNK].mul_(scales)
        blk.add_(centers[assign[s:s + _CHUNK]])
        torch.matmul(blk, mix, out=base[s:s + _CHUNK])
    del noise
    src = torch.randint(0, n, (n_queries,), generator=gen, device=device)
    queries = base[src] + QUERY_NOISE * torch.randn(
        (n_queries, d), generator=gen, device=device)
    return base, queries


def train_rows(n: int, n_train: int, seed: int, device) -> torch.Tensor | None:
    """Row ids of the training sample (sorted), or None to train on all
    rows."""
    if n_train >= n:
        return None
    perm = torch.randperm(n, generator=generator(seed, 1, device),
                          device=device)
    return torch.sort(perm[:n_train]).values


def checksum(base: torch.Tensor) -> float:
    """A sum over every row (f64), to see that rows made again are the
    same."""
    return float(base.sum(dim=0, dtype=torch.float64).abs().sum())
