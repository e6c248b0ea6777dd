#!/usr/bin/env python3
"""Where K5's time goes: the kernel beside copies of it with one part cut.

    python3 scripts/k5_breakdown.py

from the root of the repository, on a CUDA card. It compiles
``vaq_tpu_torch/csrc/groupmin_window_scan.cu`` as it is and five edited
copies with ``nvcc`` (into ``build/k5_breakdown/``), and times each with
CUDA events over the 1M probe buckets (1000 clusters of 1536 rows, d = 128,
112 slots, gs = 8), int8 rows and bf16 rows, as ``chip_smoke.py`` fills
them:

- ``kernel``: the source as it is;
- ``no_conversion``: the producers copy the rows in but neither convert
  them nor sum xn (the consumers multiply whatever the buffers hold);
- ``no_products``: the consumers skip the wgmma (the epilogue reads stale
  accumulators);
- ``no_epilogue``: the consumers skip the group minima and the writes;
- ``producers_only``: both consumer cuts, what the producers cost alone;
- ``consumers_only``: the producers neither load nor convert, what the
  consumers cost alone.

Only ``kernel`` computes K5's result; the cut copies say what each part
costs and how much of it overlaps the rest. The copies are made by
replacing exact lines of the kernel's source (the anchors below), so this
script tracks the kernel's text: an edit to those lines of
``groupmin_window_scan.cu`` must be made here too, or the script stops at
the anchor it cannot find. The last line is one JSON object of milliseconds
per variant and row type, with the card's ``nvidia-smi`` name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from vaq_tpu_torch import _build  # noqa: E402

SRC = (ROOT / "vaq_tpu_torch" / "csrc" / "groupmin_window_scan.cu").read_text()
OUT = ROOT / "build" / "k5_breakdown"


def _cut(old: str, new: str):
    def edit(src: str) -> str:
        assert old in src, f"anchor not found: {old[:60]!r}"
        return src.replace(old, new)
    return edit


_no_loads = _cut("        for (int i = pt; i < TR * cpr; i += PRODUCERS) {",
                 "        for (int i = pt; i < 0; i += PRODUCERS) {")
_no_conversion = lambda s: _cut(  # noqa: E731
    "            for (int j = half; j < kcur / 16; j += 2) {",
    "            for (int j = half; j < 0; j += 2) {")(_cut(
        "            for (int j = half; j < kcur / 8; j += 2) {",
        "            for (int j = half; j < 0; j += 2) {")(s))
_no_products = _cut(
    "              wgmma_m64n128k16(acc, da + 16 * k, db + 16 * k, sl > 0 || k > 0);",
    "              ;")
_no_epilogue = _cut("        if (warp_live) {", "        if (false) {")

VARIANTS = {
    "kernel": lambda s: s,
    "no_conversion": _no_conversion,
    "no_products": _no_products,
    "no_epilogue": _no_epilogue,
    "producers_only": lambda s: _no_epilogue(_no_products(s)),
    "consumers_only": lambda s: _no_conversion(_no_loads(s)),
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
    fn = ctypes.CDLL(str(so)).vaq_groupmin_window_scan
    fn.argtypes = list(_build._SIGNATURES["vaq_groupmin_window_scan"])
    fn.restype = ctypes.c_int
    return fn, [ln.strip() for ln in log.splitlines() if "registers" in ln]


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    d, ncl, cap, qcap, gs = cs.D_MAIN, cs.KC_NCL, cs.KC_CAP, cs.KC_QCAP, cs.KC_GS
    inputs = {}
    for dtype in ("int8", "bf16"):
        rows, w = cs._probe_rows(gen, d, dtype)
        qsl = (-2.0 * torch.randn((ncl, qcap, d), generator=gen, device=dev)).to(torch.bfloat16)
        inputs[dtype] = (qsl, rows, w)
    out = torch.empty((ncl, qcap, cap // gs), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for name, edit in VARIANTS.items():
        fn, regs = _build_variant(name, edit(SRC))
        for dtype, (qsl, rows, w) in inputs.items():
            def call():
                err = fn(qsl.data_ptr(), rows.data_ptr(), int(dtype == "int8"), w.data_ptr(),
                         None, ncl, cap, qcap, d, gs, out.data_ptr(), stream)
                assert err == 0, f"{name}: CUDA error {err} at launch"

            ms[f"{name} {dtype}"] = cs._time_ms(call, 20)
            print(f"[k5_breakdown] {name} {dtype} rows: {ms[f'{name} {dtype}']:.3f} ms "
                  f"({regs[-1] if regs else ''})", flush=True)
    print(smi)
    print(json.dumps({"k5_breakdown_ms": ms, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
