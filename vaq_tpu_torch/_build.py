"""Build and bind the hand-written CUDA kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into one shared
library with a plain C interface, which ``ctypes`` loads. The library lands in
``build/vaq_tpu_torch/`` beside the package, named by a hash of the sources
and flags, so an edit to a source builds a new one at its first use and an
unchanged tree reuses the old. ``nvcc`` is looked for at ``$CUDA_HOME`` (by
default ``/usr/local/cuda``) and then on ``PATH``.

Nothing here runs at import: the first kernel launch calls :func:`library`.
A failed build raises :class:`KernelBuildError`; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "vaq_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes never cuts a 64-bit address to an int).
_SIGNATURES = {
    # codes, n_rows, m, c, table, q, qn, nq, d, block_rows, idx_bits, n_win,
    # q_chunk, kc, table_smem, smem, keys, stream
    "vaq_decode_window_scan": (_P, _L, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                               _L, _I, _I, _I, _I, _P, _P),
    # codes, n_rows, m, cand, nq, kk, rows, qp, d, out, stream
    "vaq_decode_rescore": (_P, _L, _I, _P, _I, _I, _P, _P, _I, _P, _P),
    # qsl, rows, rows_int8, w, n_slots, ncl, cap, qcap, d, gs, out, stream
    "vaq_groupmin_window_scan": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
                                 _P),
    # q, w, rows, rows_int8, n_blk, wblk, nq, m, gs, d, out, stream
    "vaq_gather_rescore": (_P, _P, _P, _I, _L, _P, _I, _I, _I, _I, _P, _P),
    # codes, n_rows, m, lut, lut_int8, nq, c, block_rows, idx_bits, n_win,
    # q_tile, smem, tiles, kpad, keys, stream
    "vaq_fast4_window_scan": (_P, _L, _I, _P, _I, _I, _I, _I, _I, _L, _I, _I,
                              _P, _I, _P, _P),
    # q, x, b, nq, n, ld, lo, w, jaccard, out, stream
    "vaq_popcount_dists": (_P, _P, _I, _I, _L, _I, _I, _I, _I, _P, _P),
    # rows, n, d, norms, q, nq, kk, mt, warps, stages, splits, smem, cand,
    # bound, kept, stream
    "vaq_decoded_topk_scan": (_P, _L, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _P, _P, _P, _P),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the kernel sources."""


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found under {home}/bin or on PATH; the CUDA kernels "
            "of vaq_tpu_torch are built from csrc/*.cu at first use")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libvaq_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this exact one exists; returns its path.
    Each source compiles in its own ``nvcc`` process, all at once; the
    compilers' output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", str(o)]
            for p, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *(str(o) for o in objs)]
    failed = [(c, log) for c, p, log in zip(cmds, procs, logs)
              if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True,
                              check=False)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = [(link, proc.stdout + proc.stderr)]
    out.with_suffix(".log").write_text("".join(
        " ".join(c) + "\n" + log for c, log in zip(cmds + [link], logs)))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError("\n".join(
            f"{' '.join(c)}\n{log[-6000:]}" for c, log in failed))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.vaq_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vaq_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = library().vaq_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
