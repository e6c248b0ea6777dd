"""vaq_tpu_torch — the VAQ similarity-search engine in PyTorch, for one
NVIDIA H100.

A port of ``vaq_tpu`` (JAX + Pallas). Module names mirror the JAX package so
each counterpart is easy to find; ``vaq_tpu`` stays the reference the port is
tested against. This package imports ``torch`` and never ``jax`` or
``vaq_tpu``.

The slice ported so far is the main path: ``VAQIndex.train`` (PCA, bit
allocation, batched k-means), ``encode``, ``search`` on the decoded bf16 tier
and on the codes-resident tier (two hand-written CUDA kernels,
``ops/scan_codes.py``), and ``refine``.
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
from vaq_tpu_torch.errors import (ConfigError, FormatError,  # noqa: E402
                                  NotReadyError, ShapeError, VAQError)
from vaq_tpu_torch.vaq import VAQIndex  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "SearchMethod",
    "VAQConfig",
    "parse_method_string",
    "VAQIndex",
    "VAQError",
    "ConfigError",
    "NotReadyError",
    "ShapeError",
    "FormatError",
]
