#!/usr/bin/env python3
"""Where K3's and K4's time goes: the tensor-core form beside copies of it
with one part cut.

    python3 scripts/fast4_breakdown.py

from the root of the repository, on a CUDA card. It compiles
``vaq_tpu_torch/csrc/fast4_window_scan.cu`` as it is and four edited copies
with ``nvcc`` (into ``build/fast4_breakdown/``), and times each with CUDA
events at the main FAST shape (M = 64, C = 16, 1M rows padded to 1,001,472,
512 queries, 256-row windows), K3 (bf16 LUT) and K4 (s8 LUT), on inputs
made as ``chip_smoke.py`` makes them:

- ``kernel``: the source as it is;
- ``no_products``: the one-hot fragments are built but no wgmma runs (the
  epilogue reads stale accumulators);
- ``no_onehot``: the wgmma run on a constant fragment, no one-hot is built
  from the codes (the codes are still copied in);
- ``no_epilogue``: the products run, no key, minimum or store follows;
- ``products_only``: both of the last two cuts, what the tensor cores and
  the copies cost alone.

Only ``kernel`` computes K3/K4's result; the cut copies say what each part
costs and how much of it overlaps the rest. The copies are made by
replacing exact lines of the kernel's source (the anchors below), so this
script tracks the kernel's text: an edit to those lines of
``fast4_window_scan.cu`` must be made here too, or the script stops at the
anchor it cannot find. Each variant's time is taken on the kernel's launch
alone, with the LUT's tiles laid out once before. The last line is one JSON
object of milliseconds per variant and kernel, with the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from vaq_tpu_torch import _build  # noqa: E402
from vaq_tpu_torch.ops import scan_codes  # noqa: E402

SRC = (ROOT / "vaq_tpu_torch" / "csrc" / "fast4_window_scan.cu").read_text()
OUT = ROOT / "build" / "fast4_breakdown"


def _cut(old: str, new: str):
    def edit(src: str) -> str:
        assert old in src, f"anchor not found: {old[:60]!r}"
        return src.replace(old, new)
    return edit


_no_products = _cut("    Mma<INT8>::mma(acc, a[i], db0 + 16 * j, j > 0);",
                    "    keep_all(a[i]);")
_no_onehot = _cut(
    "  if constexpr (C16 && !INT8) {",
    "  if constexpr (true) {\n"
    "#pragma unroll\n"
    "    for (int i = 0; i < MMA_GROUP; ++i)\n"
    "      a[i][0] = a[i][1] = a[i][2] = a[i][3] = INT8 ? 0x01010101u : 0x3F803F80u;\n"
    "  } else if constexpr (C16 && !INT8) {")
_no_epilogue = _cut(
    "    // Epilogue. Lane (g, t) holds rows g and g + 8 of the warp's 16, columns",
    "    if (r0 >= 0) continue;\n"
    "    // Epilogue. Lane (g, t) holds rows g and g + 8 of the warp's 16, columns")

VARIANTS = {
    "kernel": lambda s: s,
    "no_products": _no_products,
    "no_onehot": _no_onehot,
    "no_epilogue": _no_epilogue,
    "products_only": lambda s: _no_epilogue(_no_onehot(s)),
}


def _build_variant(name: str, src: str):
    """(the C entry point of the variant's library, ptxas register lines)."""
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib_{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           str(cu), "-o", str(so)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
    fn = ctypes.CDLL(str(so)).vaq_fast4_window_scan
    fn.argtypes = list(_build._SIGNATURES["vaq_fast4_window_scan"])
    fn.restype = ctypes.c_int
    return fn, [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "warning" in ln]


def main() -> int:
    if not torch.cuda.is_available():
        print("fast4_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    n, m, c, nq, br = cs.KF_SHAPES[0]
    n_pad = n + (-n) % (scan_codes.W_PER_CELL * br)
    n_win = n_pad // br
    rng = np.random.default_rng(cs.SEED)
    codes = torch.as_tensor(rng.integers(0, c, (n, m), dtype=np.uint8), device=dev)
    inputs = {
        "K3": torch.as_tensor((rng.random((nq, m, c)) * 4.0).astype(np.float32), device=dev),
        "K4": torch.as_tensor(rng.integers(-128, 128, (nq, m, c), dtype=np.int8), device=dev),
    }
    keys = torch.empty((nq, n_win), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ms, want = {}, {}
    for name, edit in VARIANTS.items():
        fn, regs = _build_variant(name, edit(SRC))
        for kern, luts in inputs.items():
            int8 = kern == "K4"
            form = scan_codes._fast4_form(m, c, int8, nq, br)
            assert form.kind == "mma", form
            tiles = scan_codes._fast4_lut_tiles(luts, form)

            def call():
                keys.fill_(scan_codes._INT32_MAX)
                err = fn(codes.data_ptr(), n, m, luts.data_ptr(), int(int8), nq, form.c,
                         br, scan_codes._idx_bits(br), n_win, form.q_tile, form.smem,
                         tiles.data_ptr(), form.kpad, keys.data_ptr(), stream)
                assert err == 0, f"{name}: CUDA error {err} at launch"

            ms[f"{name} {kern}"] = cs._time_ms(call, 10)
            if name == "kernel":  # the kernel as built here is the wrapper's
                want[kern] = scan_codes.fast4_window_scan(codes, luts, br, n_win)
                call()
                got = scan_codes._unpack_fast4(keys, br, int8)
                assert all(torch.equal(a, b) for a, b in zip(got, want[kern])), kern
            ops = 2.0 * nq * n_pad * m * c
            print(f"[fast4_breakdown] {name} {kern}: {ms[f'{name} {kern}']:.3f} ms "
                  f"({ops / ms[f'{name} {kern}'] / 1e9:.1f} T{'OP' if int8 else 'FLOP'}/s) "
                  f"{regs}", flush=True)
    print(smi)
    print(json.dumps({"fast4_breakdown_ms": ms, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
