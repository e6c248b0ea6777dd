#!/usr/bin/env python3
"""Where K1's time goes: the kernel beside copies of it with one part cut.

    python3 scripts/k1_breakdown.py

from the root of the repository, on a CUDA card. It compiles
``vaq_tpu_torch/csrc/decode_window_scan.cu`` as it is and four edited copies
with ``nvcc`` (into ``build/k1_breakdown/``), and times each with CUDA events
at the codes path's shape (1M rows, M = 32, C = 256, d = 128, 512 queries,
128-row windows), with the block geometry the wrapper picks:

- ``kernel``: the source as it is;
- ``no_decode``: the producer warps hand over their buffers without
  decoding (the consumers multiply whatever the buffers hold);
- ``no_epilogue``: the consumer warps skip the window minimum and the
  writes;
- ``products_only``: both cuts, what the tensor-core products cost alone;
- ``decode_only``: the consumers skip the products and the epilogue, what
  the producers cost alone.

Only ``kernel`` computes K1's result; the cut copies say what each part
costs and how much of it overlaps the rest. The copies are made by
replacing exact lines of the kernel's source (``EPILOGUE``, ``RELEASE``
and the ``_cut`` anchors below), so this script tracks the kernel's text:
an edit to those lines of ``decode_window_scan.cu`` must be made here too,
or the script stops at the anchor it cannot find. The last line is one JSON
object of milliseconds per variant, with the card's ``nvidia-smi`` name and
power limit.
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

from vaq_tpu_torch import _build  # noqa: E402
from vaq_tpu_torch.ops import scan_codes  # noqa: E402

SRC = (ROOT / "vaq_tpu_torch" / "csrc" / "decode_window_scan.cu").read_text()
OUT = ROOT / "build" / "k1_breakdown"
N, M, C, L, NQ, BR = 1_000_000, 32, 256, 4, 512, 128


def _cut(old: str, new: str):
    def edit(src: str) -> str:
        assert old in src, f"anchor not found: {old[:60]!r}"
        return src.replace(old, new)
    return edit


EPILOGUE = "      // Epilogue: dist and key for each (row, query) held, the window min.\n"
RELEASE = "      if (qs0 + QT >= nqc) {\n        bar_arrive(BAR_EMPTY + b, THREADS);"


def _no_epilogue(src: str) -> str:
    """The epilogue replaced by a use of the accumulators that writes
    nothing (so that the products are not optimised away)."""
    a, b = src.index(EPILOGUE), src.index(RELEASE)
    keep = """      {
        float t_ = 0.f;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) t_ += acc[mt][nt][i];
        if (t_ == 1234.5f) keys[tid] = 0;
      }
"""
    return src[:a] + keep + src[b:]


_no_decode = _cut("for (int r = pw; r < TR; r += ROWS_AT_ONCE * PRODUCER_WARPS)",
                  "for (int r = pw; r < 0; r += ROWS_AT_ONCE * PRODUCER_WARPS)")
_no_products = _cut("""        if (kcur == 128) mma_depth<8>(acc, pa, pb, sx, kcur);
        else mma_depth<0>(acc, pa, pb, sx, kcur);""", "")

VARIANTS = {
    "kernel": lambda s: s,
    "no_decode": _no_decode,
    "no_epilogue": _no_epilogue,
    "products_only": lambda s: _no_epilogue(_no_decode(s)),
    "decode_only": lambda s: _no_epilogue(_no_products(s)),
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
    fn = ctypes.CDLL(str(so)).vaq_decode_window_scan
    fn.argtypes = list(_build._SIGNATURES["vaq_decode_window_scan"])
    fn.restype = ctypes.c_int
    return fn, [ln.strip() for ln in log.splitlines() if "registers" in ln]


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    d = M * L
    cents = rng.standard_normal((M, C, L)).astype(np.float32)
    codes = torch.as_tensor(rng.integers(0, C, (N, M), dtype=np.uint8), device=dev)
    qp = torch.as_tensor(rng.standard_normal((NQ, d)).astype(np.float32), device=dev)
    table = scan_codes.build_decode_table(cents, dev)
    q_bf = qp.to(torch.bfloat16).contiguous()
    qn = (qp * qp).sum(1).contiguous()
    n_win = -(-N // BR)
    q_chunk, kc, in_smem, smem = scan_codes._k1_tile(NQ, M, C, d)
    keys = torch.full((NQ, n_win), 2**31 - 1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for name, edit in VARIANTS.items():
        fn, regs = _build_variant(name, edit(SRC))

        def call():
            err = fn(codes.data_ptr(), N, M, C, table.data_ptr(), q_bf.data_ptr(),
                     qn.data_ptr(), NQ, d, BR, scan_codes._idx_bits(BR), n_win,
                     q_chunk, kc, int(in_smem), smem, keys.data_ptr(), stream)
            assert err == 0, f"{name}: CUDA error {err} at launch"

        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end) / 20
        print(f"[k1_breakdown] {name}: {ms[name]:.3f} ms ({regs[-1] if regs else ''})",
              flush=True)
    print(smi)
    print(json.dumps({"k1_breakdown_ms": ms, "q_chunk": q_chunk,
                      "table_in_smem": bool(in_smem), "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
