"""vaq_tpu_torch — the VAQ similarity-search engine in PyTorch, for one
NVIDIA H100.

A port of ``vaq_tpu`` (JAX + Pallas). Module names mirror the JAX package so
each counterpart is easy to find; ``vaq_tpu`` stays the reference the port is
tested against. This package imports ``torch`` and never ``jax`` or
``vaq_tpu``.

Ported: ``VAQIndex.train`` (PCA, bit allocation, batched k-means),
``encode``, ``search`` on the decoded bf16 tier, the int8 tier
(``"decoded8"``), the codes-resident tier (CUDA kernels K1/K2,
``ops/scan_codes.py``) and the TI/IVF cluster probe (``attach_ivf``, then
``backend="ivf"``; CUDA kernels K5/K7, ``ops/probe_scan.py`` and
``ops/rescore.py``), the FAST/LUT family, ``refine``, the mutations
(``add``, ``delete``, ``get_codes``, ``reconstruct``), the >8-bit
codebooks, the reference-format artifacts and dataset I/O (``io``,
``native``) and the ``demo_vaq`` CLI (``cli``), and every other module
of ``vaq_tpu``: the BitVecEngine (``binary``), serving, the sharded search
(``parallel``), ``fpgrowth``, the clustering demos and the on-card kernel
gate (``ops/kernel_check``). Entry points run on ``"cuda"`` unless given
``device="cpu"``; without a card they raise ``DeviceError``.
"""

import torch as _torch

# Precision policy: every f32 matmul runs in full f32. The JAX package learned
# this on its TPU (vaq_tpu/__init__.py:28-38): a one-pass bf16 default left the
# brute-force groundtruth only 89.2% correct (top-10 vs f64 at 100k x 128d).
# Hopper's equivalent trap is TF32 (about three decimal digits): cuBLAS f32
# matmuls may use it when allow_tf32 is set, and cuDNN uses it by default.
# PCA, k-means, encode's argmin and the groundtruth all assume f32 math. Paths
# that want bf16 pass explicitly-bf16 operands, which these flags do not touch.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from vaq_tpu_torch.config import (SearchMethod, VAQConfig,  # noqa: E402
                                  parse_method_string)
from vaq_tpu_torch.errors import (ConfigError, DeviceError,  # noqa: E402
                                  FormatError, NotReadyError, ShapeError,
                                  VAQError)
from vaq_tpu_torch.ivf import attach_ivf  # noqa: E402
from vaq_tpu_torch.vaq import VAQIndex  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "SearchMethod",
    "VAQConfig",
    "parse_method_string",
    "VAQIndex",
    "attach_ivf",
    "VAQError",
    "ConfigError",
    "DeviceError",
    "NotReadyError",
    "ShapeError",
    "FormatError",
]
