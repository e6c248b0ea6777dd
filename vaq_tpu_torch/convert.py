"""Build port objects from state held as numpy arrays.

``index_from_numpy`` takes the JAX package's ``save()`` keys
(vaq_tpu/vaq.py:1081-1110): ``eigvecs``, ``eigvals``, ``var_per_subs``,
``cum_var_per_subs``, ``bits``, ``centroids``, ``centroid_counts``, and
optionally row-major ``codes``, ``deleted_ids`` and
``lut_offsets``/``lut_scales``. ``meta`` is the save() meta dict
(``config``, ``subs_len``, ``highest_subs``, ``orig_dim``, ``n_rows``).
``VAQIndex.load`` goes through here, and the parity tests feed it a
JAX-trained index's state directly, so both packages search one state.

``ivf_state_from_numpy`` does the same for the cluster-probe buckets of a
JAX ``IVFState`` (vaq_tpu/ivf.py:54-86), so both packages can search one
IVF state with no k-means noise between them.

``binary_index_from_numpy`` and ``hamming_clusters_from_numpy`` carry the
binary engine's state across (vaq_tpu/binary.py:170-187, 666-674): a
``BinaryIndex`` from JAX's ``save()`` arrays and meta (``BinaryIndex.load``
goes through here), and a ``HammingClusterState`` from its fields, so both
packages search one Hamming cluster state (the two k-means can differ in
their last bits).
"""

from __future__ import annotations

import numpy as np
import torch

from vaq_tpu_torch.binary import (BinaryIndex, HammingClusterState,
                                  _device_words)
from vaq_tpu_torch.config import SearchMethod, VAQConfig
from vaq_tpu_torch.device import DEFAULT, resolve
from vaq_tpu_torch.ivf import IVFState
from vaq_tpu_torch.vaq import VAQIndex


def index_from_numpy(arrays: dict, meta: dict,
                     device: torch.device | str = DEFAULT) -> VAQIndex:
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
        idx.codes = idx._device_codes(codes)
        idx.n_rows = codes.shape[0]
    if "lut_offsets" in arrays:
        idx.lut_offsets = np.asarray(arrays["lut_offsets"])
        idx.lut_scales = np.asarray(arrays["lut_scales"])
    if "deleted_ids" in arrays:
        idx.deleted_ids = np.asarray(arrays["deleted_ids"])
    return idx


def ivf_state_from_numpy(arrays: dict,
                         device: torch.device | str = DEFAULT) -> IVFState:
    """An IVFState on ``device`` from a JAX IVFState's fields as numpy
    arrays: ``centroids``, ``seg_dims``, ``cap``, ``bucket_rows``,
    ``bucket_ids``, ``sizes``, optionally ``dim_scales`` (int8 rows) and
    ``transposed``. A transposed (ncl, D, cap) state is swapped to the
    port's row-major (ncl, cap, D). bf16 rows may come as any float dtype
    whose values are bf16 (ml_dtypes' bfloat16 included)."""
    dev = resolve(device)

    def copy(a, dtype=None):
        # torch.tensor copies: the arrays may be read-only views of JAX's
        return torch.tensor(np.ascontiguousarray(a, dtype=dtype), device=dev)

    rows = np.asarray(arrays["bucket_rows"])
    if arrays.get("transposed", False):
        rows = rows.swapaxes(1, 2)
    rows_t = (copy(rows) if rows.dtype == np.int8
              else copy(rows, np.float32).to(torch.bfloat16))
    scales = arrays.get("dim_scales")
    return IVFState(
        centroids=np.asarray(arrays["centroids"], dtype=np.float32),
        seg_dims=int(arrays["seg_dims"]),
        cap=int(arrays["cap"]),
        bucket_rows=rows_t,
        bucket_ids=copy(arrays["bucket_ids"], np.int32),
        sizes=copy(arrays["sizes"], np.int32),
        dim_scales=None if scales is None else copy(scales, np.float32))


def binary_index_from_numpy(arrays: dict, meta: dict,
                            device: torch.device | str = DEFAULT
                            ) -> BinaryIndex:
    """A BinaryIndex on ``device`` holding exactly the given state: JAX's
    ``save()`` keys ``eigvecs``, ``bits``, ``boundaries`` and optionally
    uint32 ``packed``; ``meta`` its ``bit_budget``, ``seed``,
    ``total_bits``, ``orig_dim``, ``n_rows``."""
    idx = BinaryIndex(bit_budget=meta["bit_budget"], seed=meta["seed"],
                      device=device)
    idx.eigvecs = np.asarray(arrays["eigvecs"], dtype=np.float32)
    idx.bits = np.asarray(arrays["bits"])
    idx.boundaries = np.asarray(arrays["boundaries"], dtype=np.float32)
    idx.total_bits = int(meta["total_bits"])
    idx.orig_dim = int(meta["orig_dim"])
    idx.n_rows = int(meta["n_rows"])
    if "packed" in arrays:
        idx._set_rows(np.asarray(arrays["packed"]))
    return idx


def hamming_clusters_from_numpy(arrays: dict,
                                device: torch.device | str = DEFAULT
                                ) -> HammingClusterState:
    """A HammingClusterState on ``device`` from a JAX state's fields as
    numpy arrays: ``centroids``, ``cap``, uint32 ``bucket_words`` (ncl, cap,
    W), ``bucket_ids``, ``sizes``."""
    dev = resolve(device)
    return HammingClusterState(
        centroids=np.array(arrays["centroids"], dtype=np.float32),
        cap=int(arrays["cap"]),
        bucket_words=_device_words(arrays["bucket_words"], dev),
        bucket_ids=torch.tensor(np.asarray(arrays["bucket_ids"], np.int32),
                                device=dev),
        sizes=torch.tensor(np.asarray(arrays["sizes"], np.int32), device=dev))
