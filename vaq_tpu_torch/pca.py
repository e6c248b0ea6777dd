"""PCA rotation training: covariance, eigendecomposition, subspace balancing.

The counterpart of ``vaq_tpu/pca.py`` (reference ``VAQ.cpp:11-336``):

* uncentered covariance XᵀX (the reference does not subtract the mean,
  VAQ.cpp:37) over a sample of ≤ 1000·d rows, accumulated in f32 on the
  device in 256k-row blocks;
* the same float64 host ``eigh``, descending sort, partial variance-balancing
  swaps (VAQ.cpp:236-280), normalized explained variance and the
  ``highest_subs`` truncation (VAQ.cpp:301-334).

Everything after XᵀX is the JAX version's numpy code. XᵀX itself is summed in
another order than XLA's, so eigenvector signs may flip and near-degenerate
pairs may turn; the tests compare statistics (eigenvalues, bit allocation,
recall), not the vectors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vaq_tpu_torch.rng import DEFAULT_SEED, sample_rows

COV_BLOCK_ROWS = 256 * 1024      # VAQ.cpp:16
COV_SAMPLE_PER_DIM = 1000        # VAQ.cpp:17


@dataclasses.dataclass
class RotationResult:
    eigvecs: np.ndarray          # (d, d) f32, columns in final (sorted+swapped) order
    eigvals: np.ndarray          # (d,) f32, same order
    var_per_dim: np.ndarray      # normalized + clamped explained variance
    var_per_subs: np.ndarray     # per-subspace sums
    cum_var_per_subs: np.ndarray
    highest_subs: int            # number of kept subspaces
    subs_len: int                # dims per subspace L


def uncentered_cov(x: torch.Tensor) -> torch.Tensor:
    """XᵀX accumulated in f32 row blocks (the reference's numerics)."""
    d = x.shape[1]
    cov = torch.zeros((d, d), dtype=torch.float32, device=x.device)
    for start in range(0, x.shape[0], COV_BLOCK_ROWS):
        blk = x[start:start + COV_BLOCK_ROWS]
        cov += blk.T @ blk
    return cov


def train_rotation(
    x: np.ndarray,
    subspace_num: int,
    percent_var_explained: float = 1.0,
    seed: int = DEFAULT_SEED,
    device: torch.device | str = "cpu",
) -> RotationResult:
    """Compute the (sorted, variance-balanced) PCA rotation and truncation."""
    x = np.asarray(x, dtype=np.float32)
    d = x.shape[1]
    subs_len = (d + subspace_num - 1) // subspace_num  # ceil, VAQ.cpp:104-107
    if d % subspace_num != 0:
        raise ValueError(
            f"dims {d} must be pre-padded to a multiple of subspace_num "
            f"{subspace_num} (use io.pad_dims)"
        )

    sample = sample_rows(x, COV_SAMPLE_PER_DIM * d, seed)
    cov = uncentered_cov(torch.as_tensor(sample, device=device)).cpu().numpy()

    # Symmetric eigendecomposition; eigh returns ascending order.
    evals, evecs = np.linalg.eigh(cov.astype(np.float64))
    order = np.argsort(-evals, kind="stable")
    evals = evals[order]
    evecs = evecs[:, order]

    # Partial variance balancing swaps (VAQ.cpp:262-280).
    L, M = subs_len, subspace_num
    idx = np.arange(d)

    def subs_sums(e):
        return e[: M * L].reshape(M, L).sum(axis=1)

    max_swap = min(L, M)
    for i in range(1, max_swap):
        j = i * L + (L - 1)
        idx[[i, j]] = idx[[j, i]]
        if not np.all(np.diff(subs_sums(evals[idx])) <= 0):
            idx[[i, j]] = idx[[j, i]]  # undo and stop
            break

    evals = evals[idx]
    evecs = evecs[:, idx]

    # Explained variance, normalized then clamped (VAQ.cpp:301-313).
    var_per_dim = evals / evals.sum()
    var_per_dim = np.maximum(var_per_dim, 1e-12)
    var_per_subs = var_per_dim[: M * L].reshape(M, L).sum(axis=1)
    cum_var = np.cumsum(var_per_subs)

    if percent_var_explained < 1.0:
        highest = 0
        for i in range(M):
            if cum_var[i] <= percent_var_explained:
                highest = i
        highest += 1
    else:
        highest = M

    return RotationResult(
        eigvecs=evecs.astype(np.float32),
        eigvals=evals.astype(np.float32),
        var_per_dim=var_per_dim.astype(np.float32),
        var_per_subs=var_per_subs.astype(np.float32),
        cum_var_per_subs=cum_var.astype(np.float64),
        highest_subs=int(highest),
        subs_len=int(subs_len),
    )


def project(x: torch.Tensor, eigvecs: torch.Tensor,
            total_dim: int | None = None) -> torch.Tensor:
    """Project rows onto the rotation (reference ProjectOnEigenVectors,
    VAQ.hpp:198-305): one f32 matmul on x's device."""
    if total_dim is not None:
        eigvecs = eigvecs[:, :total_dim]
    return x.to(torch.float32) @ eigvecs.to(device=x.device, dtype=torch.float32)
