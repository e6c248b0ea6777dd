"""VAQ's training and the TI clustering worked out again, plainly, from the
same rows the program was built from: a yardstick that takes no table of the
program.

* :func:`rotation`: the eigenvectors of the training rows' uncentred second
  moments, in descending order of eigenvalue, then VAQ's partial balancing
  swaps (dimension ``i`` trades places with the last dimension of subspace
  ``i`` while the subspaces' variance sums stay non-increasing); the
  normalised variance per subspace and its cumulative sum.
* :func:`allocate_bits`: the bit allocation VAQ states: maximise
  ``Σ var_i · bits_i`` with ``Σ bits_i`` the budget, ``lb_i ≤ bits_i ≤
  max_bits`` (``lb_i`` is ``min_bits`` while the cumulative variance is
  within the configured share, else 0) and ``bits_i − bits_{i+1} ≤
  2^⌊log2(var_i / var_{i+1})⌋``, solved exactly by dynamic programming.
  Where a cumulative share lies within rounding of the configured share
  (as the last one does at a share of 1), either lower bound holds, and
  :func:`quantizers` trains each allocation that the two give.
* :func:`kmeans`: Lloyd's iterations from distinct random rows; an empty
  cluster keeps its centroid.
* :func:`quantizers`: one codebook a subspace, ``2^bits`` centroids, each
  trained by :func:`kmeans` on ``max(256·2^bits, 256·2^(budget/M))``
  training rows drawn from a seed.
* :func:`recon_error`: the mean squared distance between rows and their
  reconstructions (nearest centroid a subspace, rotated back).
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
KMEANS_ITERS = 25
BLOCK = 1 << 16


def pad_cols(x: torch.Tensor, d: int) -> torch.Tensor:
    return x if x.shape[1] >= d else torch.nn.functional.pad(
        x, (0, d - x.shape[1]))


def rotation(x: torch.Tensor, m: int, pct: float = 1.0) -> dict:
    """``{"eigvecs" (d, d) f64, "var_per_subs" (m,), "cum_var" (m,),
    "kept" (subspaces kept), "sub_len"}`` of rows ``x`` padded to a multiple
    of ``m`` columns."""
    sub_len = -(-x.shape[1] // m)
    d = sub_len * m
    cov = torch.zeros((d, d), dtype=F64, device=x.device)
    for s in range(0, x.shape[0], BLOCK):
        b = pad_cols(x[s:s + BLOCK].to(F64), d)
        cov += b.T @ b
    evals, evecs = torch.linalg.eigh(cov)
    order = torch.argsort(-evals, stable=True)
    evals, evecs = evals[order].cpu().numpy(), evecs[:, order]
    perm = np.arange(d)

    def sums(e):
        return e[:m * sub_len].reshape(m, sub_len).sum(axis=1)

    for i in range(1, min(sub_len, m)):
        j = i * sub_len + sub_len - 1
        perm[[i, j]] = perm[[j, i]]
        if np.any(np.diff(sums(evals[perm])) > 0):
            perm[[i, j]] = perm[[j, i]]
            break
    evals = evals[perm]
    var = np.maximum(evals / evals.sum(), 1e-12)
    var_subs = sums(var)
    cum = np.cumsum(var_subs)
    kept = m if pct >= 1.0 else int(np.sum(cum <= pct) or 1)
    return {"eigvecs": evecs[:, torch.as_tensor(perm, device=evecs.device)],
            "var_per_subs": var_subs[:kept], "cum_var": cum[:kept],
            "kept": kept, "sub_len": sub_len}


def _step_cap(hi: float, lo: float) -> int:
    r = hi / lo if lo != 0 else math.inf
    if not math.isfinite(r) or r <= 0:
        return 0
    return int(2.0 ** math.floor(math.log2(r)))


def allocate_bits(var: np.ndarray, cum: np.ndarray, budget: int,
                  min_bits: int, max_bits: int, pct: float,
                  lb: list | None = None) -> np.ndarray:
    """The exact optimum of VAQ's bit-allocation program (module doc);
    ``lb`` overrides the lower bounds."""
    m = len(var)
    if lb is None:
        lb = [min_bits if cum[i] <= pct else 0 for i in range(m)]
    caps = [_step_cap(var[i], var[i + 1]) for i in range(m - 1)]
    neg = -math.inf
    # best[x][s]: the best sum over subspaces 0..i with bits_i = x and
    # Σ bits = s; back[i][x][s]: bits_{i-1} on that best path
    best = [[neg] * (budget + 1) for _ in range(max_bits + 1)]
    for x in range(lb[0], min(max_bits, budget) + 1):
        best[x][x] = var[0] * x
    back = []
    for i in range(1, m):
        new = [[neg] * (budget + 1) for _ in range(max_bits + 1)]
        arg = [[-1] * (budget + 1) for _ in range(max_bits + 1)]
        for y in range(lb[i], max_bits + 1):
            for s in range(y, budget + 1):
                for x in range(0, min(max_bits, y + caps[i - 1]) + 1):
                    v = best[x][s - y]
                    if v > neg and v + var[i] * y > new[y][s]:
                        new[y][s] = v + var[i] * y
                        arg[y][s] = x
        best = new
        back.append(arg)
    x = max(range(max_bits + 1), key=lambda y: best[y][budget])
    if best[x][budget] == neg:
        raise ValueError("no bit allocation meets the constraints")
    bits = [x]
    s = budget
    for arg in reversed(back):
        prev = arg[x][s]
        s -= x
        x = prev
        bits.append(x)
    return np.array(bits[::-1], dtype=np.int64)


def _nearest(x: torch.Tensor, c: torch.Tensor) -> tuple:
    """(index, squared distance) of each row's nearest centroid, f32
    products in row blocks."""
    cn = (c * c).sum(dim=1)
    idx = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    dist = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    rows = max(1, (1 << 27) // max(1, c.shape[0]))
    for s in range(0, x.shape[0], rows):
        b = x[s:s + rows]
        d = (b * b).sum(dim=1, keepdim=True) - 2.0 * (b @ c.T) + cn
        dist[s:s + rows], idx[s:s + rows] = torch.min(d, dim=1)
    return idx, torch.clamp_min(dist, 0.0)


def kmeans(x: torch.Tensor, k: int, gen: torch.Generator,
           iters: int = KMEANS_ITERS) -> torch.Tensor:
    """(k, dim) f32 centroids of rows ``x`` by Lloyd's iterations."""
    x = x.to(torch.float32)
    n = x.shape[0]
    if n >= k:
        pick = torch.randperm(n, generator=gen, device=x.device)[:k]
    else:
        pick = torch.randint(0, n, (k,), generator=gen, device=x.device)
    c = x[pick].clone()
    for _ in range(iters):
        a, _ = _nearest(x, c)
        sums = torch.zeros_like(c).index_add_(0, a, x)
        cnt = torch.bincount(a, minlength=k).to(torch.float32)[:, None]
        c = torch.where(cnt > 0, sums / torch.clamp_min(cnt, 1.0), c)
    return c


# how near the configured share a cumulative share is taken to lie on it
EDGE = 1e-6


def quantizers(x_train: torch.Tensor, m: int, budget: int, min_bits: int,
               max_bits: int, pct: float, gen: torch.Generator) -> list:
    """VAQ trained from ``x_train``: the rotation, the bits and a codebook
    (``2^bits`` f32 centroids) a subspace; one quantizer for each
    allocation the rule admits (two where a cumulative share lies on the
    configured one, module doc)."""
    rot = rotation(x_train, m, pct)
    cum = rot["cum_var"]
    lbs = [[min_bits if c < pct - EDGE or (c <= pct + EDGE and edge) else 0
            for c in cum] for edge in (True, False)]
    allocs = []
    for lb in lbs:
        bits = allocate_bits(rot["var_per_subs"], cum, budget, min_bits,
                             max_bits, pct, lb)
        if not any(np.array_equal(bits, b) for b in allocs):
            allocs.append(bits)
    e32 = rot["eigvecs"].to(torch.float32)
    sub = rot["sub_len"]
    n = x_train.shape[0]
    floor = 256 * (1 << (budget // m))
    out = []
    for bits in allocs:
        books = []
        for s, b in enumerate(bits):
            k = 1 << int(b)
            take = min(n, max(256 * k, floor))
            rows = torch.randperm(n, generator=gen,
                                  device=x_train.device)[:take]
            xs = pad_cols(x_train[rows].to(torch.float32), e32.shape[0]) \
                @ e32[:, s * sub:(s + 1) * sub]
            books.append(kmeans(xs, k, gen))
        out.append({**rot, "bits": bits, "books": books})
    return out


def recon_error(x: torch.Tensor, q: dict) -> float:
    """Mean ``‖x − x̂‖²`` of rows ``x`` under quantizer ``q`` (f64)."""
    e = q["eigvecs"]
    sub = q["sub_len"]
    xp = pad_cols(x.to(F64), e.shape[0])
    rot = xp @ e
    rec = torch.zeros_like(rot)
    for s, c in enumerate(q["books"]):
        sl = slice(s * sub, (s + 1) * sub)
        a, _ = _nearest(rot[:, sl].to(torch.float32), c)
        rec[:, sl] = c[a].to(F64)
    return float(((xp - rec @ e.T) ** 2).sum(dim=1).mean())


def program_recon_error(x: torch.Tensor, eigvecs: torch.Tensor,
                        codes: torch.Tensor, centroids: torch.Tensor) -> float:
    """Mean ``‖x − x̂‖²`` of rows ``x`` against the reconstructions that
    ``codes`` name, rotated back by ``eigvecs`` (d, T) (f64)."""
    from benchmark.reference.adc import reconstruct
    e = eigvecs.to(device=x.device, dtype=F64)
    xp = pad_cols(x.to(F64), e.shape[0])
    rec = reconstruct(codes, centroids)
    return float(((xp - rec @ e.T) ** 2).sum(dim=1).mean())


def nearest_error(x: torch.Tensor, c: torch.Tensor) -> float:
    """Mean squared distance of rows ``x`` to the nearest of centroids
    ``c`` (f64)."""
    x, c = x.to(F64), c.to(F64)
    cn = (c * c).sum(dim=1)
    total = 0.0
    for s in range(0, x.shape[0], 1 << 14):
        b = x[s:s + (1 << 14)]
        d = (b * b).sum(dim=1, keepdim=True) - 2.0 * (b @ c.T) + cn
        total += float(torch.clamp_min(d.min(dim=1).values, 0.0).sum())
    return total / x.shape[0]


def nearest_ranks(x: torch.Tensor, c: torch.Tensor,
                  chosen: torch.Tensor) -> torch.Tensor:
    """For each row of ``x``, how many centroids lie strictly nearer to it
    than centroid ``chosen`` (f64)."""
    x, c = x.to(F64), c.to(F64)
    cn = (c * c).sum(dim=1)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], 1 << 14):
        b = x[s:s + (1 << 14)]
        d = (b * b).sum(dim=1, keepdim=True) - 2.0 * (b @ c.T) + cn
        mine = d.gather(1, chosen[s:s + (1 << 14), None])
        out[s:s + b.shape[0]] = (d < mine).sum(dim=1)
    return out
