"""``groupmin_window_scan_roofline``: the probe's group-min stage (K5,
inside the program's ``ivf.groupmin`` range) against its bound, in %.

The bound of one batch counts once the bytes of the live rows of every
bucket that has at least one dispatched query (not the padding up to the
buckets' common capacity), plus each dispatched (query, cluster) entry's bf16
query row and its f32 minima, one a group of ``gs`` live rows, at the H100's
3.35 TB/s. The
dispatch is worked out again here from the probe's state and the batch's
queries, by the rule the probe states: each query's ``p_max`` nearest
clusters, the nearest ``max(p_visit, a prefix of >= k members)`` active,
each cluster taking its first ``qcap`` queries by id. The time is the
device time under the range, a batch. It reads the stage and not a kernel's
name, so it measures the same work whatever implements it."""

import torch

from benchmark.harness import peaks, trace

BATCHES_COUNTED = 16


def batch_bytes(qp, centroids, sizes, dim, elem_bytes, k, p_visit, p_max,
                qcap, gs):
    """The bytes the stage needs for one batch of projected queries."""
    seg = centroids.shape[1]
    q = qp[:, :seg]
    cd = (q * q).sum(1, keepdim=True) - 2.0 * q @ centroids.T \
        + (centroids * centroids).sum(1)[None, :]
    probe = torch.sort(cd, dim=1, stable=True).indices[:, :p_max]
    cum = torch.cumsum(sizes.to(torch.int64)[probe], dim=1)
    p_q = torch.clamp(torch.clamp_min(1 + (cum < k).sum(1), p_visit), 1,
                      p_max)
    active = torch.arange(p_max, device=qp.device)[None, :] < p_q[:, None]
    ncl = centroids.shape[0]
    member = torch.zeros((qp.shape[0], ncl), dtype=torch.int64,
                         device=qp.device)
    member.scatter_(1, probe, active.to(torch.int64))
    per_cluster = torch.clamp(member.sum(0), max=qcap)
    sizes = sizes.to(device=qp.device, dtype=torch.int64)
    rows = int(sizes[per_cluster > 0].sum())
    entries = int(per_cluster.sum())
    minima = int((per_cluster * ((sizes + gs - 1) // gs)).sum())
    return rows * dim * elem_bytes + entries * dim * 2 + minima * 4


def read(ctx):
    tr = ctx["trace"]
    count = trace.range_count(tr, "ivf.groupmin")
    idx = ctx["index"]
    if not count or getattr(idx, "ivf", None) is None:
        return None
    t = trace.in_range_s(tr, "ivf.groupmin") / count
    st = idx.ivf.state
    nb = int(ctx["traffic"]["query_batch"])
    p_visit, p_max, qcap, gs = idx.ivf.params(ctx["k"], nb)
    dev = st.bucket_rows.device
    ev = torch.as_tensor(idx.eigvecs[:, :idx.total_dim], device=dev)
    cents = torch.as_tensor(st.centroids, device=dev)
    qs = ctx["queries"]
    total = 0
    for j in range(min(BATCHES_COUNTED, ctx["window"]["batches"])):
        rows = (torch.arange(nb) + j * nb) % qs.shape[0]
        q = torch.as_tensor(qs[rows.numpy()], device=dev)
        if q.shape[1] < ev.shape[0]:
            q = torch.nn.functional.pad(q, (0, ev.shape[0] - q.shape[1]))
        total += batch_bytes(q @ ev, cents, st.sizes, st.d_full,
                             st.bucket_rows.element_size(), ctx["k"],
                             p_visit, p_max, qcap, gs)
    mean = total / min(BATCHES_COUNTED, ctx["window"]["batches"])
    return 100.0 * peaks.bound_s(nbytes=mean) / t if t > 0 else None
