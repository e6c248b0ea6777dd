"""LUT-side search pieces; for now the exact refine.

The counterpart of ``vaq_tpu/ops/scan_jax.py``. Only ``refine_topk``
(scan_jax.py:133-153, reference VAQ::refine, VAQ.cpp:849-876) is on the
ported slice; the LUT build and the LUT gather scan join this module with
the FAST family.
"""

from __future__ import annotations

from typing import Tuple

import torch


def refine_topk(queries: torch.Tensor, db_candidates: torch.Tensor,
                cand_labels: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact rerank of R candidates per query: recompute exact squared L2
    in f32 and keep the k best.

    queries (nq, d) original-space; db_candidates (nq, R, d) gathered rows;
    cand_labels (nq, R) their global ids (−1 marks padding, never kept
    ahead of a real row).
    """
    diff = queries[:, None, :] - db_candidates
    d2 = torch.sum(diff * diff, dim=2)
    d2 = torch.where(cand_labels >= 0, d2, torch.inf)
    top, pos = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    return top, torch.gather(cand_labels, 1, pos)
