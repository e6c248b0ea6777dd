#!/usr/bin/env python3
"""Time the gather form of the FAST window-scan kernels K3 (f32 LUT) and
K4 (s8 LUT) of ``vaq_tpu_torch`` over a grid of query-tile sizes, on one
CUDA card.

    python3 scripts/fast4_tile_sweep.py

from the root of the repository. The wrapper's shape rule
(``scan_codes._fast4_form``) sends wide tables to the gather form; at
``chip_smoke.py``'s wide shape (M = 32, C = 256, 262,144 rows, 128 queries,
512-row windows) and each (LUT bytes a block stages, queries a tile holds
at most), it prints the query tile that
``scan_codes._fast4_tile`` picks, the block's shared memory and the
kernel's mean time by CUDA events; every result must equal the first
setting's keys bit for bit. ``_FAST4_LUT_BYTES`` and ``_FAST4_MAX_Q_TILE``
in ``ops/scan_codes.py`` hold the best setting found.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from vaq_tpu_torch.ops import scan_codes as sc  # noqa: E402

SHAPES = ((262_144, 32, 256, 128, 512),)
BUDGETS_KB = (96, 80, 64, 48, 32)
MAX_Q_TILES = (64, 32, 16, 8)


def time_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("fast4_tile_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for n, m, c, nq, br in SHAPES:
        codes = torch.as_tensor(rng.integers(0, c, (n, m), dtype=np.uint8),
                                device=dev)
        n_win = (n + (-n) % (sc.W_PER_CELL * br)) // br
        luts = {"K3": torch.as_tensor(
                    (rng.random((nq, m, c)) * 4).astype(np.float32), device=dev),
                "K4": torch.as_tensor(
                    rng.integers(-128, 128, (nq, m, c), dtype=np.int8),
                    device=dev)}
        first = {}
        for budget in BUDGETS_KB:
            for q_max in MAX_Q_TILES:
                sc._FAST4_LUT_BYTES, sc._FAST4_MAX_Q_TILE = budget * 1024, q_max
                row = []
                for name, lut in luts.items():
                    assert sc._fast4_form(m, c, name == "K4", nq, br).kind == "gather"
                    q_tile, smem = sc._fast4_tile(m, c, lut.element_size(), nq, br)
                    out = sc.fast4_window_scan(codes, lut, br, n_win)
                    ref = first.setdefault(name, out)
                    assert all(torch.equal(a, b) for a, b in zip(out, ref))
                    ms = time_ms(lambda: sc.fast4_window_scan(codes, lut, br, n_win))
                    row.append(f"{name} q_tile {q_tile:2d}, {smem // 1024:3d} KB, "
                               f"{ms:.3f} ms")
                print(f"M={m} C={c} LUT {budget} KB, q_tile <= {q_max}: "
                      + " | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
