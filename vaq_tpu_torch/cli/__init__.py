"""CLI entry points mirroring the reference's examples/demo_*.cpp binaries
(the counterpart of ``vaq_tpu/cli/``)."""

import os

from vaq_tpu_torch.errors import ConfigError


def platform_device() -> str:
    """The device a demo runs on, read from ``VAQ_TPU_PLATFORM`` where the
    JAX demos read their platform (vaq_tpu/cli/__init__.py:6-17): unset,
    empty or ``cuda`` is the card, ``cpu`` the CPU; anything else raises
    ConfigError."""
    plat = os.environ.get("VAQ_TPU_PLATFORM") or "cuda"
    if plat not in ("cuda", "cpu"):
        raise ConfigError(
            f"VAQ_TPU_PLATFORM={plat!r}: the PyTorch demos run on 'cuda' "
            "(the default) or 'cpu'")
    return plat
