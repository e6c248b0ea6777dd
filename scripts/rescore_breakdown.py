#!/usr/bin/env python3
"""Where K7's and K2's time goes: each kernel beside copies of it with one
part cut.

    python3 scripts/rescore_breakdown.py

from the root of the repository, on a CUDA card. It compiles
``vaq_tpu_torch/csrc/gather_rescore.cu`` (K7) and ``decode_rescore.cu``
(K2) as they are and edited copies with ``nvcc`` (into
``build/rescore_breakdown/``), and times each with CUDA events at
``chip_smoke.py``'s shapes: K7 over 512 queries × 200 windows of 8 rows
drawn from the 1M probe buckets, int8 and bf16 rows at d = 128 and int8 at
d = 96 (K8); K2 over 512 queries × 200 candidates of the 1M × 32 codes
(C = 256, d = 128).

- ``kernel``: the source as it is;
- ``loads_only``: K7's warps fill their rings as they do, and wait for
  each slot and refill it without reading it (the gather rate the bulk
  copies reach for these windows); K2 issues its three stages of loads and
  sums the values it loads once, without the differences and squares;
- ``no_loads``: K7's warps issue no copy, only the barrier arrivals, and
  score whatever their rings hold; K2 takes its ids, code bytes and table
  values from arithmetic instead of memory;
- ``handshake_only`` (K7): both cuts, what the rings' barriers cost alone;
- ``cp_async`` and ``cp_async_loads_only`` (K7): the alternative fill, the
  same ring filled by 16-byte ``cp.async`` copies from every lane with
  their completion counted on the slot's barrier, in full and without the
  arithmetic.

Only ``kernel`` is held to the plain version (by the tests and
``chip_smoke.py``); ``cp_async`` is timed, not checked; the cut copies say what each
part costs and how much of it overlaps the rest. The copies are made by
replacing exact lines of the kernels' sources (the anchors below), so this
script tracks the kernels' text: an edit to those lines must be made here
too, or the script stops at the anchor it cannot find. The last line is
one JSON object of milliseconds and GB/s (the bytes of each kernel's bound
over its time) per kernel and variant, with the card's ``nvidia-smi`` name
and power limit.
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

CSRC = ROOT / "vaq_tpu_torch" / "csrc"
OUT = ROOT / "build" / "rescore_breakdown"


def _cut(*pairs):
    def edit(src: str) -> str:
        for old, new in pairs:
            assert old in src, f"anchor not found: {old[:60]!r}"
            src = src.replace(old, new)
        return src
    return edit


_k7_no_reads = _cut(("    float mine = NAN;\n    if (it.wid >= 0 && it.wid < g.n_blk) {",
                     "    float mine = NAN;\n    if (false) {"))
_k7_no_copies = _cut(("    if (lane != 0) return;\n    if (it.wid >= 0 && it.wid < g.n_blk) {",
                      "    if (lane != 0) return;\n    if (false) {"))
# The alternative fill: every lane copies 16-byte pieces of the chunk by
# cp.async and arrives on the slot's barrier when its own copies land
# (cp.async.mbarrier.arrive.noinc), so the phase turns at 32 arrivals.
_k7_cp_async = _cut(
    ("    for (int s = 0; s < D; ++s) mbar_init(&full[s], 1);",
     "    for (int s = 0; s < D; ++s) mbar_init(&full[s], 32);"),
    ("""    if (lane != 0) return;
    if (it.wid >= 0 && it.wid < g.n_blk) {
      const uint32_t bytes = static_cast<uint32_t>(min(g.rpc, g.gs - it.r0) * g.row_bytes);
      mbar_arrive_tx(&full[s], bytes);
      bulk_copy(ring + static_cast<size_t>(s) * g.slot_bytes,
                reinterpret_cast<const unsigned char*>(rows) +
                    (static_cast<int64_t>(it.wid) * g.gs + it.r0) * g.row_bytes,
                bytes, &full[s]);
    } else {""",
     """    if (it.wid >= 0 && it.wid < g.n_blk) {
      const int bytes = min(g.rpc, g.gs - it.r0) * g.row_bytes;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(rows) +
                                 (static_cast<int64_t>(it.wid) * g.gs + it.r0) * g.row_bytes;
      unsigned char* dst = ring + static_cast<size_t>(s) * g.slot_bytes;
      for (int v = lane; v < bytes / 16; v += 32)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(smem_u32(dst + 16 * v)),
                     "l"(src + 16 * v) : "memory");
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n" ::"r"(
          smem_u32(&full[s])) : "memory");
    } else {"""))

VARIANTS = {
    "gather_rescore": {
        "kernel": lambda s: s,
        "loads_only": _k7_no_reads,
        "no_loads": _k7_no_copies,
        "handshake_only": lambda s: _k7_no_reads(_k7_no_copies(s)),
        "cp_async": _k7_cp_async,
        "cp_async_loads_only": lambda s: _k7_no_reads(_k7_cp_async(s)),
    },
    "decode_rescore": {
        "kernel": lambda s: s,
        "loads_only": _cut((
            "            const float diff = x[b][i][e] - q[i][e];\n"
            "            acc[b] = __fmaf_rn(diff, diff, acc[b]);",
            "            acc[b] += x[b][i][e];")),
        "no_loads": _cut(
            ("id = __ldg(crow + b0 + lane);", "id = b0 + lane;"),
            ("__ldg(cr + sub[i])", "static_cast<uint32_t>(sub[i])"),
            ("load_unit<U>(rows + static_cast<int64_t>(code[b][i]) * d + U * u, x[b][i]);",
             "for (int e = 0; e < U; ++e) x[b][i][e] = static_cast<float>(code[b][i] + e);")),
    },
}


def _build_variant(kernel: str, name: str, src: str):
    """(the C entry point of the variant's library, ptxas register lines)."""
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{kernel}_{name}.cu", OUT / f"lib_{kernel}_{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           str(cu), "-o", str(so)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"{kernel} {name}: nvcc failed\n{log[-4000:]}")
    entry = f"vaq_{kernel}"
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = list(_build._SIGNATURES[entry])
    fn.restype = ctypes.c_int
    return fn, [ln.strip() for ln in log.splitlines() if "registers" in ln]


def _k7_cases(gen, dev):
    """(label, launch arguments before the output, bytes of the bound,
    output size, tensors to keep alive) for K7."""
    cases = []
    for d, dtype in ((cs.D_MAIN, "int8"), (cs.D_MAIN, "bf16"), (96, "int8")):
        rows, w = cs._probe_rows(gen, d, dtype)
        n_blk = rows.shape[0] // cs.KC_GS
        q = torch.randn((cs.KC_NQ, d), generator=gen, device=dev).to(torch.bfloat16)
        wblk = torch.randint(0, n_blk, (cs.KC_NQ, cs.KC_WIN), generator=gen,
                             device=dev, dtype=torch.int32)
        gathered = cs.KC_NQ * cs.KC_WIN * cs.KC_GS * d
        nbytes = (gathered * rows.element_size() + cs.KC_NQ * d * 4 + d * 4
                  + wblk.numel() * 4 + cs.KC_NQ * cs.KC_WIN * cs.KC_GS * 4)
        args = (q.data_ptr(), w.data_ptr(), rows.data_ptr(), int(dtype == "int8"),
                n_blk, wblk.data_ptr(), cs.KC_NQ, cs.KC_WIN, cs.KC_GS, d)
        cases.append((f"d={d} {dtype}", args, nbytes, cs.KC_NQ * cs.KC_WIN * cs.KC_GS,
                      (rows, w, q, wblk)))
    return cases


def _k2_case(dev):
    rng = np.random.default_rng(cs.SEED)
    d = cs.KC_M * cs.KC_L
    cents = rng.standard_normal((cs.KC_M, cs.KC_C, cs.KC_L)).astype(np.float32)
    codes = torch.as_tensor(rng.integers(0, cs.KC_C, (cs.KC_N, cs.KC_M), dtype=np.uint8),
                            device=dev)
    qp = torch.as_tensor(rng.standard_normal((cs.KC_NQ, d)).astype(np.float32), device=dev)
    rows = scan_codes.build_decode_rows(cents, dev)
    cand = torch.as_tensor(rng.integers(0, cs.KC_N, (cs.KC_NQ, cs.KC_KK), dtype=np.int32),
                           device=dev)
    n_cand = cs.KC_NQ * cs.KC_KK
    nbytes = n_cand * (cs.KC_M + 4 + 4) + rows.numel() * 4 + qp.numel() * 4
    args = (codes.data_ptr(), cs.KC_N, cs.KC_M, cand.data_ptr(), cs.KC_NQ, cs.KC_KK,
            rows.data_ptr(), qp.data_ptr(), d)
    return [("M=32 C=256", args, nbytes, n_cand, (codes, qp, rows, cand))]


def main() -> int:
    if not torch.cuda.is_available():
        print("rescore_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    cases = {"gather_rescore": _k7_cases(gen, dev), "decode_rescore": _k2_case(dev)}
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for kernel, variants in VARIANTS.items():
        src = (CSRC / f"{kernel}.cu").read_text()
        for name, edit in variants.items():
            fn, regs = _build_variant(kernel, name, edit(src))
            for label, args, nbytes, n_out, _keep in cases[kernel]:
                out = torch.empty(n_out, device=dev)

                def call():
                    err = fn(*args, out.data_ptr(), stream)
                    assert err == 0, f"{kernel} {name}: CUDA error {err} at launch"

                ms = cs._time_ms(call, 20)
                gbs = nbytes / (ms * 1e-3) / 1e9
                result[f"{kernel} {label} {name}"] = {"ms": ms, "GB/s": gbs}
                print(f"[rescore_breakdown] {kernel} {label} {name}: {ms:.4f} ms, "
                      f"{gbs:.0f} GB/s ({regs[0] if regs else ''})", flush=True)
    print(smi)
    print(json.dumps({"rescore_breakdown": result, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
