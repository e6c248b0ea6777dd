"""Readings that set a cell's limits; not part of a benchmark run.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --variants none,control,fault:untrained --seconds 3 [--out FILE]

runs the cell once for each seed and variant, in one process, at the cell's
own sizes and load, with a short window, and prints one JSON line a run with
the numbers that decide ``correct`` (``harness/variants.py`` says what each
variant breaks; ``none`` is the program as it stands). The limits in
``limits/<cell>.json`` lie between the sound runs' largest reading and the
smallest reading of the control or of a fault.
"""

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="none,control")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    from benchmark.harness import cell as cell_mod
    from benchmark.harness.spec import load_cell

    if not torch.cuda.is_available():
        cell_mod.log("no CUDA device")
        return 2
    cell = load_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant in args.variants.split(","):
            out = cell_mod.run_cell(cell, seed, args.seconds, False, "cuda",
                                    variant=None if variant == "none"
                                    else variant)
            row = {"workload": args.workload, "seed": seed,
                   "variant": variant, "numbers": out["numbers"],
                   "metrics": {k: v["value"] for k, v in
                               out["line"]["metrics"].items()},
                   "notes": out["notes"]}
            rows.append(row)
            print(json.dumps(cell_mod.jsonable(row)), flush=True)
            del out
            gc.collect()
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(cell_mod.jsonable(row)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
