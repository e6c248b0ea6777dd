"""Build a port index from an index's state as numpy arrays.

The arrays are the JAX package's ``save()`` keys (vaq_tpu/vaq.py:1081-1110):
``eigvecs``, ``eigvals``, ``var_per_subs``, ``cum_var_per_subs``, ``bits``,
``centroids``, ``centroid_counts``, and optionally row-major ``codes``,
``deleted_ids`` and ``lut_offsets``/``lut_scales``. ``meta`` is the save()
meta dict (``config``, ``subs_len``, ``highest_subs``, ``orig_dim``,
``n_rows``). ``VAQIndex.load`` goes through here, and the parity tests feed
it a JAX-trained index's state directly, so both packages search one state.
"""

from __future__ import annotations

import numpy as np
import torch

from vaq_tpu_torch.config import SearchMethod, VAQConfig
from vaq_tpu_torch.vaq import VAQIndex


def index_from_numpy(arrays: dict, meta: dict,
                     device: torch.device | str = "cpu") -> VAQIndex:
    """A VAQIndex on ``device`` holding exactly the given state."""
    cfg_d = dict(meta["config"])
    cfg_d["methods"] = SearchMethod(cfg_d["methods"])
    if cfg_d.get("hardcoded_bits"):
        cfg_d["hardcoded_bits"] = tuple(cfg_d["hardcoded_bits"])
    idx = VAQIndex(config=VAQConfig(**cfg_d), device=device)
    idx.eigvecs = np.asarray(arrays["eigvecs"], dtype=np.float32)
    idx.eigvals = np.asarray(arrays["eigvals"], dtype=np.float32)
    idx.var_per_subs = np.asarray(arrays["var_per_subs"])
    idx.cum_var_per_subs = np.asarray(arrays["cum_var_per_subs"])
    idx.bits = np.asarray(arrays["bits"], dtype=np.int64)
    idx.centroids = np.asarray(arrays["centroids"], dtype=np.float32)
    idx.centroid_counts = np.asarray(arrays["centroid_counts"],
                                     dtype=np.int64)
    idx.subs_len = int(meta["subs_len"])
    idx.highest_subs = int(meta["highest_subs"])
    idx.orig_dim = int(meta["orig_dim"])
    idx.n_rows = int(meta["n_rows"])
    if "codes" in arrays:
        codes = np.asarray(arrays["codes"])
        dtype = np.uint8 if int(idx.bits.max()) <= 8 else np.int32
        idx.codes = torch.as_tensor(np.ascontiguousarray(codes.astype(dtype)),
                                    device=idx.device)
        idx.n_rows = codes.shape[0]
    if "lut_offsets" in arrays:
        idx.lut_offsets = np.asarray(arrays["lut_offsets"])
        idx.lut_scales = np.asarray(arrays["lut_scales"])
    if "deleted_ids" in arrays:
        idx.deleted_ids = np.asarray(arrays["deleted_ids"])
    return idx
