"""Distributed k-means: Lloyd iterations over row-sharded data.

The counterpart of ``vaq_tpu/parallel/dist_kmeans.py``. Training rows are
sharded over the "db" axis; each Lloyd iteration computes every shard's
per-cluster sums and counts at full f32 (exact products, as
``kmeans.lloyd`` computes them) and reduces them in shard order — the
counterpart of the reference's OpenMP private-accumulate + ordered-merge
k-means (``KMeans.hpp:562-595``) and of JAX's one ``psum`` a step. With a
process group on the "db" axis the per-shard sums of every rank are
gathered first (one ``all_gather`` a step), so the reduction keeps shard
order and the result equals one process's with the same shards.
"""

from __future__ import annotations

import torch

from vaq_tpu_torch import kmeans
from vaq_tpu_torch.parallel.mesh import Mesh
from vaq_tpu_torch.parallel.sharded import (ShardedRows, _gather_ranks,
                                            _shard_span, split_rows)


def lloyd_sharded(
    x: ShardedRows,
    init_centroids: torch.Tensor,
    n_total: int,
    iters: int,
    mesh: Mesh,
    db_axis: str = "db",
) -> torch.Tensor:
    """Run Lloyd iterations with rows sharded over ``db_axis``.

    Args:
      x: sharded training rows (``shard_rows_for``); pad rows at or past
        ``n_total`` are ignored.
      init_centroids: (k, d) initial centroids.
      n_total: the true row count.
    Returns: (k, d) centroids on the mesh's first device."""
    grid = mesh.rows(db_axis)
    lead = grid[0, 0]
    c = init_centroids.to(lead, torch.float32)
    shards = [part[:_shard_span(x, j, n_total)[1]]
              for j, part in enumerate(x.parts[0])]
    grouped = mesh.group is not None and mesh.group_axis == db_axis
    for _ in range(iters):
        sums, counts = [], []
        for part in shards:
            s, n = kmeans._cluster_sums(part[None], c.to(part.device)[None])
            sums.append(s.to(lead))
            counts.append(n.to(lead))
        sums, counts = torch.cat(sums), torch.cat(counts)   # (S_local, ...)
        if grouped:
            sums = _gather_ranks(sums, mesh.group, 0)
            counts = _gather_ranks(counts, mesh.group, 0)
        tot_s, tot_n = sums[0], counts[0]
        for s, n in zip(sums[1:], counts[1:]):               # shard order
            tot_s, tot_n = tot_s + s, tot_n + n
        c = kmeans._lloyd_update(tot_s, tot_n, c)
    return c


def shard_rows_for(mesh: Mesh, x: torch.Tensor, db_axis: str = "db"
                   ) -> ShardedRows:
    """Pad + place rows sharded over the db axis."""
    return split_rows(x, mesh, db_axis)
