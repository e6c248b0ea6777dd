"""Library error hierarchy.

Copied verbatim from ``vaq_tpu/errors.py``: importing it from there would
run ``vaq_tpu/__init__.py``, which imports jax, and this package never does.

The reference engine fails with bare ``assert(false)`` / ``exit(1)``
(e.g. VAQ.cpp's method-parse dead ends, IO.hpp's format checks); a library
surface needs typed, catchable failures instead. Every class subclasses
``ValueError`` so pre-existing ``except ValueError`` callers (and tests)
keep working.

Usage convention:
* ``ConfigError``   — malformed method strings / inconsistent VAQConfig
  (parse_method_string, allocator budget violations).
* ``NotReadyError`` — using an index before the pipeline stage it needs
  (search before train/encode, refine before encode, IVF before attach).
* ``ShapeError``    — query/base dimensionality or dtype mismatches.
* ``FormatError``   — on-disk artifact parse failures (fvecs/bvecs/npz,
  reference binary interop).
"""

from __future__ import annotations


class VAQError(ValueError):
    """Base class for all vaq_tpu errors."""


class ConfigError(VAQError):
    """Invalid method string, config field, or config/state combination."""


class NotReadyError(VAQError):
    """Operation requires an earlier pipeline stage (train/encode/attach)."""


class ShapeError(VAQError):
    """Input array shape/dtype incompatible with the index."""


class FormatError(VAQError):
    """On-disk dataset or artifact failed to parse."""
