#!/usr/bin/env python
"""Sharded-vs-unsharded IVF recall at 100k rows on the PyTorch port.

    python3 scripts/check_sharded_100k_torch.py [--shards 8] [--device cuda]
        [--out scripts/sharded_100k_check_torch.json]

The counterpart of ``scripts/check_sharded_100k.py``: a 100k × 128-d index
of ``VAQ256m32min7max8var1,TI64m16`` (the TI probe: 64 clusters over 16
subspaces), its probe state attached at visit 1.0, 256 queries, k = 10,
searched unsharded (the int8 probe with its exact second stage over the
decoded tier) and then cluster-sharded over ``--shards`` shards
(``VAQIndex.shard(tiers=("decoded", "ivf"))``: each shard runs kernels K5
and K7 on its clusters, the second stage is distributed). At visit 1.0 both probe every cluster, so the stage-1
candidate sets are the same and the recalls must agree within 0.005; the
run fails, with its record printed, when they do not. The static query
capacity (``qcap``) must hold every query a cluster receives: the record
counts the (query, cluster) entries it drops, on each side.

On one card the mesh repeats the card (``make_mesh(devices=[dev] * S)``:
S shards run one after another on it). ``--device cpu`` runs the same on
the CPU, the kernels through their plain versions. The rows are the first
100k of ``make_anisotropic_gaussian(1_000_000, 128, 1024, seed=42)`` (as
JAX slices its bench cache; ``bench_torch.py``'s cache is reused), the
groundtruth ``exact_search`` at f32 on the device. The record (JAX's fields,
plus the card's ``nvidia-smi`` name and power limit, the probe's parameters,
the dropped entries and K5/K7's launches) is printed and written to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench_torch  # noqa: E402
import vaq_tpu_torch as vt  # noqa: E402
from vaq_tpu_torch import io, ivf, metrics, pca  # noqa: E402
from vaq_tpu_torch.device import resolve  # noqa: E402
from vaq_tpu_torch.ops import distances, probe  # noqa: E402
from vaq_tpu_torch.parallel import make_mesh  # noqa: E402

METHOD = "VAQ256m32min7max8var1,TI64m16"
N, NQ, K = 100_000, 256, 10
TOLERANCE = 0.005
OUT = os.path.join(HERE, "sharded_100k_check_torch.json")


def dropped_entries(state, qp: torch.Tensor, k: int, p_visit: int,
                    p_max: int, qcap: int) -> int:
    """(query, cluster) entries of one probe batch on ``state`` that the
    static ``qcap`` drops (``ops/probe.dispatch_table``; ROADMAP fault 8)."""
    cents = torch.as_tensor(state.centroids, device=qp.device)
    cd = probe.cluster_sq_dists(qp[:, :state.seg_dims], cents)
    pr, active = probe.dynamic_probe(cd, state.sizes, k, p_visit, p_max)
    _, ok, _, _ = probe.dispatch_table(pr, active, state.ncl,
                                       min(qcap, qp.shape[0]))
    return int(active.sum()) - int(ok.sum())


def sharded_check(idx, queries: np.ndarray, gt: np.ndarray, k: int,
                  mesh) -> dict:
    """The unsharded probe search of ``idx`` (probe state attached), then
    ``idx.shard(mesh, tiers=("decoded", "ivf"))`` and the sharded one.
    Returns JAX's record fields (recalls rounded to 4 places, as JAX's),
    ``recalls_agree`` (|Δ| < 0.005 before rounding, JAX's assertion), the
    probe's parameters, the entries qcap dropped, the windows K7 rescores a
    query on each shard and K5/K7's launches on each side. ``idx`` stays
    sharded."""
    nq = queries.shape[0]
    # JAX's attach_ivf leaves the decoded tier resident, so its unsharded
    # probe runs the exact second stage; so does this one
    idx._ensure_decoded()
    qp = pca.project(torch.as_tensor(
        io.pad_dims(np.asarray(queries, np.float32), idx.config.subspace_num),
        device=idx.device), idx._eigvecs_device())
    before = bench_torch.kernel_launches()
    _, l_ref = idx.search(queries, k)
    launches_ref = bench_torch.launches_since(before)
    r_ref = metrics.avg_recall(l_ref, gt, k)
    p_ref = idx.ivf.params(k, nq)
    drop_ref = dropped_entries(idx.ivf.state, qp, k, *p_ref[:3])

    idx.shard(mesh, tiers=("decoded", "ivf"))
    sh = idx._sharded_ivf
    assert sh.rescore_rows is not None
    before = bench_torch.kernel_launches()
    _, l_sh = idx.search(queries, k)
    launches_sh = bench_torch.launches_since(before)
    r_sh = metrics.avg_recall(l_sh, gt, k)
    agree = float(np.mean(l_sh[:, 0] == l_ref[:, 0]))
    # each shard's stage 1 keeps 2k candidates for the exact second stage
    p_sh = sh.params(k, nq)
    drop_sh = sum(dropped_entries(st, qp, 2 * k, *p_sh[:3])
                  for row in sh.shards for st in row)
    ng = sh.cap // p_sh[3]
    return {"n": idx.n_rows, "nq": nq, "k": k, "devices": mesh.shape["db"],
            "unsharded_recall": round(float(r_ref), 4),
            "sharded_recall": round(float(r_sh), 4),
            "delta": round(float(r_sh - r_ref), 4),
            "top1_agreement": round(agree, 4),
            "recalls_agree": bool(abs(r_sh - r_ref) < TOLERANCE),
            "visit": sh.visit, "clusters": idx.ivf.state.ncl,
            "clusters_per_shard": sh.ncl_local, "cap": sh.cap,
            "d": sh.d_full, "rows_dtype": str(idx.ivf.state.bucket_rows.dtype),
            "unsharded_p_visit_p_max_qcap_gs": list(p_ref),
            "sharded_p_visit_p_max_qcap_gs": list(p_sh),
            "sharded_windows": min(max(4 * k, 16), p_sh[1] * ng),
            "unsharded_dropped_entries": drop_ref,
            "sharded_dropped_entries": drop_sh,
            "unsharded_launches": launches_ref,
            "sharded_launches": launches_sh}


def run(base: np.ndarray, queries: np.ndarray, shards: int = 8, k: int = K,
        method: str = METHOD, device: torch.device | str = "cuda"):
    """Build the index on ``base`` (train, encode, the probe state at visit
    1.0), take the groundtruth, and run :func:`sharded_check` over
    ``shards`` shards of ``device``. Returns (the record, the sharded
    index)."""
    dev = resolve(device)
    _, gt = distances.exact_search(torch.as_tensor(queries, device=dev),
                                   torch.as_tensor(base, device=dev), k)
    gt = gt.cpu().numpy()
    idx = vt.VAQIndex(vt.parse_method_string(method), device=dev)
    idx.train(base).encode(base)
    ivf.attach_ivf(idx, visit=1.0)
    out = sharded_check(idx, queries, gt, k,
                        make_mesh(devices=[dev] * shards))
    return out, idx


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    dev = resolve(args.device)
    env = bench_torch.environment(dev)
    base, queries = bench_torch.bench_data(
        os.path.join(os.path.dirname(HERE), ".bench_cache", "torch"),
        1_000_000, 128, 1024)
    out, _ = run(base[:N], queries[:NQ], args.shards, device=dev)
    out = {**out, "config": METHOD, "device": env["device_name"],
           "nvidia_smi": env["nvidia_smi"]}
    print(json.dumps(out))
    assert out["recalls_agree"], out
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
