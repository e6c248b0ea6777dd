"""VAQ's semantics written out plainly, in f64, in row blocks.

An index is a rotation ``E`` (d, D), per-subspace codebooks (M, C, L) of
which subspace ``s`` uses its first ``counts[s]`` rows, and one code per row
and subspace. A row's reconstruction is the concatenation of its codes'
centroids; a query's asymmetric (ADC) distance to a row is
``‖q·E − x̂‖²``; a search returns the k rows of least distance. Encoding a
row picks, per subspace, the centroid nearest to its rotated slice.

Every function takes plain tensors and returns plain numbers or tensors.
"""

from __future__ import annotations

import torch

F64 = torch.float64
BLOCK_ROWS = 1 << 17


def rotate(x: torch.Tensor, eigvecs: torch.Tensor) -> torch.Tensor:
    """Rows zero-padded to the rotation's height, then rotated (f64)."""
    x = x.to(F64)
    if x.shape[1] < eigvecs.shape[0]:
        x = torch.nn.functional.pad(x, (0, eigvecs.shape[0] - x.shape[1]))
    return x @ eigvecs.to(device=x.device, dtype=F64)


def reconstruct(codes: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(rows, M) codes → (rows, M·L) f64 reconstructions."""
    m = codes.shape[1]
    sub = torch.arange(m, device=codes.device)
    return centroids.to(F64)[sub[None, :], codes.to(torch.int64)].reshape(
        codes.shape[0], -1)


def adc_dists(q_rot: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor,
              centroids: torch.Tensor) -> torch.Tensor:
    """(S, k) ADC distances of each query to the rows ``ids`` (S, k); an id
    outside the rows gives ``nan``."""
    n = codes.shape[0]
    ok = (ids >= 0) & (ids < n)
    safe = torch.where(ok, ids, 0).to(torch.int64)
    rows = reconstruct(codes[safe.reshape(-1)], centroids).reshape(
        *ids.shape, -1)
    d = ((q_rot[:, None, :] - rows) ** 2).sum(dim=2)
    return torch.where(ok, d, torch.nan)


def _lowest(d: torch.Tensor, ids: torch.Tensor, k: int):
    top, pos = torch.topk(d, k, dim=1, largest=False, sorted=True)
    return top, torch.gather(ids, 1, pos)


def topk_blocks(q: torch.Tensor, n: int, rows_of, k: int,
                block: int = BLOCK_ROWS):
    """The k least ``‖q − x‖²`` over ``n`` rows that ``rows_of(start, stop)``
    gives as f64 blocks: (dists (S, k), ids (S, k))."""
    q = q.to(F64)
    qn = (q * q).sum(dim=1, keepdim=True)
    best_d = best_i = None
    for s in range(0, n, block):
        x = rows_of(s, min(n, s + block))
        d = qn - 2.0 * (q @ x.T) + (x * x).sum(dim=1)[None, :]
        ids = torch.arange(s, s + x.shape[0], device=q.device).expand_as(d)
        kk = min(k, d.shape[1])
        bd, bi = _lowest(d, ids, kk)
        if best_d is not None:
            bd = torch.cat([best_d, bd], dim=1)
            bi = torch.cat([best_i, bi], dim=1)
        best_d, best_i = _lowest(bd, bi, min(k, bd.shape[1]))
    return best_d, best_i


def adc_topk(q_rot: torch.Tensor, codes: torch.Tensor,
             centroids: torch.Tensor, k: int):
    """The exact ADC top-k over every row."""
    return topk_blocks(q_rot, codes.shape[0],
                       lambda a, b: reconstruct(codes[a:b], centroids), k)


def exact_topk(q: torch.Tensor, base: torch.Tensor, k: int):
    """The exact top-k over the raw rows (the true neighbours)."""
    return topk_blocks(q, base.shape[0], lambda a, b: base[a:b].to(F64), k)


def encode(x_rot: torch.Tensor, centroids: torch.Tensor,
           counts: torch.Tensor) -> torch.Tensor:
    """(rows, M) nearest-centroid codes of rotated rows, each subspace
    searched over its first ``counts[s]`` centroids; ties to the lower
    centroid."""
    m, c, l = centroids.shape
    cent = centroids.to(F64)
    xs = x_rot[:, :m * l].reshape(x_rot.shape[0], m, l)
    out = torch.empty((x_rot.shape[0], m), dtype=torch.int64,
                      device=x_rot.device)
    for s in range(m):
        cs = cent[s, :int(counts[s])]
        cn = (cs * cs).sum(dim=1)
        for a in range(0, xs.shape[0], 1 << 14):
            xb = xs[a:a + (1 << 14), s]
            d = (xb * xb).sum(dim=1, keepdim=True) - 2.0 * (xb @ cs.T) + cn
            out[a:a + xb.shape[0], s] = torch.argmin(d, dim=1)
    return out


def rotation_moments(x: torch.Tensor, eigvecs: torch.Tensor) -> tuple:
    """(the largest off-diagonal entry of ``Eᵀ·XᵀX·E`` over its largest
    diagonal one, its diagonal): the ratio is 0 where ``E`` holds
    eigenvectors of the rows' (uncentred) second moments, as a PCA rotation
    does, and the diagonal is then their variances."""
    e = eigvecs.to(device=x.device, dtype=F64)
    cov = torch.zeros((x.shape[1], x.shape[1]), dtype=F64, device=x.device)
    for s in range(0, x.shape[0], BLOCK_ROWS):
        b = x[s:s + BLOCK_ROWS].to(F64)
        cov += b.T @ b
    if cov.shape[0] < e.shape[0]:
        cov = torch.nn.functional.pad(
            cov, (0, e.shape[0] - cov.shape[0], 0, e.shape[0] - cov.shape[0]))
    a = e.T @ cov @ e
    diag = torch.diagonal(a)
    off = a - torch.diag(diag)
    return float(off.abs().max() / diag.abs().max()), diag


class tf32:
    """Float32 matrix products in TF32 inside the block (the precision just
    below full f32), as the control of an f32 stage."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old


def adc_topk_f32(q: torch.Tensor, eigvecs: torch.Tensor, codes: torch.Tensor,
                 centroids: torch.Tensor, k: int, fp8: bool = False):
    """The ADC top-k with every step in f32 products (``‖q‖² − 2q·x +
    ‖x‖²``); under :class:`tf32`, the control of an f32 search. ``fp8``
    rounds the rotated query and the rows to float8 (e4m3) for the product,
    the control of a bf16 one."""
    e = eigvecs.to(device=q.device, dtype=torch.float32)
    qp = q.to(torch.float32)
    if qp.shape[1] < e.shape[0]:
        qp = torch.nn.functional.pad(qp, (0, e.shape[0] - qp.shape[1]))
    qp = qp @ e
    cent = centroids.to(torch.float32)
    m = codes.shape[1]
    sub = torch.arange(m, device=codes.device)
    qn = (qp * qp).sum(dim=1, keepdim=True)
    q8 = qp.to(torch.float8_e4m3fn).to(torch.float32) if fp8 else qp
    best_d = best_i = None
    for s in range(0, codes.shape[0], BLOCK_ROWS):
        blk = codes[s:s + BLOCK_ROWS].to(torch.int64)
        x = cent[sub[None, :], blk].reshape(blk.shape[0], -1)
        xn = (x * x).sum(dim=1)[None, :]
        if fp8:
            x = x.to(torch.float8_e4m3fn).to(torch.float32)
        d = qn - 2.0 * (q8 @ x.T) + xn
        ids = torch.arange(s, s + x.shape[0], device=q.device).expand_as(d)
        bd, bi = _lowest(d, ids, min(k, d.shape[1]))
        if best_d is not None:
            bd, bi = torch.cat([best_d, bd], 1), torch.cat([best_i, bi], 1)
        best_d, best_i = _lowest(bd, bi, min(k, bd.shape[1]))
    return torch.clamp_min(best_d, 0.0), best_i


def encode_f32(x: torch.Tensor, eigvecs: torch.Tensor, centroids: torch.Tensor,
               counts: torch.Tensor) -> torch.Tensor:
    """:func:`encode` with the rotation and the scores in f32 products;
    under :class:`tf32`, the control of the program's f32 encode."""
    e = eigvecs.to(device=x.device, dtype=torch.float32)
    x = x.to(torch.float32)
    if x.shape[1] < e.shape[0]:
        x = torch.nn.functional.pad(x, (0, e.shape[0] - x.shape[1]))
    xr = x @ e
    m, c, l = centroids.shape
    cent = centroids.to(torch.float32)
    xs = xr[:, :m * l].reshape(xr.shape[0], m, l)
    out = torch.empty((xr.shape[0], m), dtype=torch.int64, device=x.device)
    for s in range(m):
        cs = cent[s, :int(counts[s])]
        cn = (cs * cs).sum(dim=1)
        for a in range(0, xs.shape[0], 1 << 14):
            xb = xs[a:a + (1 << 14), s]
            out[a:a + xb.shape[0], s] = torch.argmin(
                cn[None, :] - 2.0 * (xb @ cs.T), dim=1)
    return out
