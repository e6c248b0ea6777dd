"""Index artifact IO: dimension padding and the full-state ``.npz``.

The counterpart of ``vaq_tpu/io.py:194-247``, with the same ``.npz`` layout,
so an index saved by either package loads in the other. The dataset readers
and the reference-binary interop wait for a later port slice.
"""

from __future__ import annotations

import json

import numpy as np


def pad_dims(x: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad feature dims to a multiple (demo_vaq.cpp:66-72 does the same
    so that d divides evenly into subspaces)."""
    d = x.shape[1]
    target = ((d + multiple - 1) // multiple) * multiple
    if target == d:
        return x
    out = np.zeros((x.shape[0], target), dtype=x.dtype)
    out[:, :d] = x
    return out


def save_index_npz(path: str, arrays: dict, meta: dict) -> None:
    """Persist full index state: numpy arrays plus a JSON meta blob."""
    payload = dict(arrays)
    payload["__meta_json__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    np.savez(path, **payload)


def load_index_npz(path: str):
    """Inverse of :func:`save_index_npz`: returns (arrays, meta)."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta_json__"}
        meta = json.loads(bytes(z["__meta_json__"].tobytes()).decode("utf-8"))
    return arrays, meta
