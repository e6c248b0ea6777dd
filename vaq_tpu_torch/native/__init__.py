"""Native host-runtime components with transparent numpy fallback.

Copied from ``vaq_tpu/native/__init__.py`` with three changes: the shared
object is built into ``build/vaq_tpu_torch/`` (git-ignored) instead of next
to the source; it is written under a temporary name and moved into place
with ``os.replace``, so test workers that build at once never load a
half-written file; and there is no environment switch to skip the build
(tests force the numpy paths by setting ``_mod``/``_tried``). ``vaq_native.cpp`` (CPython C API + OpenMP) is compiled
with ``g++`` on first use. The device compute path never goes through here —
these are the host-side pieces that are C++ in the reference too (dataset
parsing, bit packing, streamed top-k merge). If no compiler is available the
numpy implementations (``vaq_tpu_torch.io``'s reader, the callers' own
paths) are used instead; everything stays functional.
"""

from __future__ import annotations

import os
import sysconfig
from typing import Optional

import numpy as np

from vaq_tpu_torch._build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_mod = None
_tried = False


def _build() -> Optional[object]:
    """Compile + load the extension, caching the .so in the build dir."""
    import importlib.util
    import subprocess

    src = os.path.join(_HERE, "vaq_native.cpp")
    so_path = os.path.join(BUILD_DIR, "vaq_native.so")
    if (not os.path.exists(so_path)
            or os.path.getmtime(so_path) < os.path.getmtime(src)):
        include = sysconfig.get_paths()["include"]
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
            "-std=c++17", f"-I{include}", src, "-o", tmp,
        ]
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except Exception:
            return None
    spec = importlib.util.spec_from_file_location("vaq_native", so_path)
    if spec is None or spec.loader is None:
        return None
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except Exception:
        return None
    return mod


def get() -> Optional[object]:
    """The loaded extension module, or None when unavailable."""
    global _mod, _tried
    if not _tried:
        _tried = True
        _mod = _build()
    return _mod


# ---------------------------------------------------------------------------
# numpy-signature wrappers
# ---------------------------------------------------------------------------

def pack_codes(buckets: np.ndarray, bits: np.ndarray) -> Optional[np.ndarray]:
    """Native MSB-first packer; None → caller uses the numpy path."""
    mod = get()
    if mod is None:
        return None
    buckets = np.ascontiguousarray(buckets, dtype=np.int64)
    bits = np.ascontiguousarray(bits, dtype=np.int64)
    n, d = buckets.shape
    total = int(bits.sum())
    nwords = (total + 31) // 32
    raw = mod.pack_codes(buckets.tobytes(), bits.tobytes(), n, d)
    return np.frombuffer(raw, dtype=np.uint32).reshape(n, nwords).copy()


def read_vecs(path: str, elem_dtype, max_rows=None) -> Optional[np.ndarray]:
    mod = get()
    if mod is None:
        return None
    elem_dtype = np.dtype(elem_dtype)
    try:
        body, n, dim = mod.read_vecs(path, int(elem_dtype.itemsize),
                                     -1 if max_rows is None else int(max_rows))
    except ValueError as e:
        # the C parser raises plain ValueError; re-type to the library's
        # failure surface so callers can catch FormatError uniformly
        from vaq_tpu_torch.errors import FormatError

        raise FormatError(str(e)) from None
    return np.frombuffer(body, dtype=elem_dtype).reshape(n, dim).copy()


def merge_topk(best_d: np.ndarray, best_i: np.ndarray, new_d: np.ndarray,
               new_i: np.ndarray) -> bool:
    """In-place top-k merge; False → caller uses the numpy path."""
    mod = get()
    if mod is None:
        return False
    nq, k = best_d.shape
    m = new_d.shape[1]
    mod.merge_topk(best_d, best_i,
                   np.ascontiguousarray(new_d, np.float32).tobytes(),
                   np.ascontiguousarray(new_i, np.int32).tobytes(),
                   nq, k, m)
    return True
