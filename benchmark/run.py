"""Run one cell of the benchmark of ``vaq_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the checked numbers beside their limits
on standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``. Exits non-zero, printing no
result, without a CUDA device (or with fewer than the cell asks for), or if
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch
    from benchmark.harness import cell as cell_mod
    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        cell_mod.log("no CUDA device: the benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        cell_mod.log(f"{args.workload} needs {cell.chips} cards, "
                     f"{torch.cuda.device_count()} present")
        return 2
    out = cell_mod.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    found = cell_mod.forbidden_modules()
    if found:
        cell_mod.log(f"JAX or the JAX package was loaded: {found}")
        return 3
    cell_mod.report(out)
    print(json.dumps(cell_mod.jsonable(out["line"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
