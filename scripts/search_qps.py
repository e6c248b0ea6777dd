#!/usr/bin/env python3
"""Search QPS of the port's codes and IVF tiers, repeated, on a CUDA card.

    python3 scripts/search_qps.py [--root DIR] [--reps N]

builds ``chip_smoke.py``'s 1M × 128 index (seeded synthetic data,
``VAQ256m32min7max8var1,HEAP``, ``attach_ivf`` with 1000 clusters over 16
subspaces) with the ``vaq_tpu_torch`` and ``chip_smoke.py`` found under
``--root`` (by default this checkout; an unpacked ``git archive`` of another
commit measures that commit), then times ``search(queries, 100)`` over the
1000 queries, ``--reps`` times each (after one warm-up call), on the codes
tier and on the IVF tier at chip_smoke's visits. ``chip_smoke.py`` times one
call of each; host-bound paths spread too much for one call to compare two
commits, so this reports the median, lowest and highest QPS of the
repeats, and each tier's avg_recall@100. The last line is one JSON object
with those numbers and the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("search_qps: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    import chip_smoke as cs
    import vaq_tpu_torch as vt
    from vaq_tpu_torch import data, ivf, metrics
    from vaq_tpu_torch.ops import distances

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    base, queries = data.make_anisotropic_gaussian(cs.N_MAIN, cs.D_MAIN, cs.NQ_MAIN,
                                                   seed=cs.SEED)
    _, gt = distances.exact_search(torch.as_tensor(queries, device=dev),
                                   torch.as_tensor(base, device=dev), 100)
    gt = gt.cpu().numpy()
    idx = vt.VAQIndex(vt.parse_method_string(cs.METHOD), device=dev)
    idx.train(base)
    idx.encode(base)
    ivf.attach_ivf(idx, ti_cluster_num=cs.TI_CLUSTERS, ti_segment_num=cs.TI_SEGMENTS)

    result = {}
    for tier, visit in [("codes", None)] + [("ivf", v) for v in cs.VISITS]:
        if visit is not None:
            idx.ivf.visit = visit
        search = lambda: idx.search(queries, 100, backend=tier)  # noqa: E731
        _, labels = search()
        torch.cuda.synchronize()
        qps = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            search()
            torch.cuda.synchronize()
            qps.append(cs.NQ_MAIN / (time.perf_counter() - t0))
        name = tier if visit is None else f"ivf visit={visit}"
        result[name] = {"qps_median": float(np.median(qps)), "qps_min": min(qps),
                        "qps_max": max(qps),
                        "avg_recall@100": float(metrics.avg_recall(labels, gt, 100))}
        r = result[name]
        print(f"[search_qps] {name}: median {r['qps_median']:.0f} QPS "
              f"({r['qps_min']:.0f}-{r['qps_max']:.0f} over {args.reps}), "
              f"avg_recall@100 {r['avg_recall@100']:.4f}", flush=True)
    print(smi)
    print(json.dumps({"search_qps": result, "root": str(args.root), "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
