"""The accelerator a measurement runs on.

Every measurement path (``chip_smoke.py``, ``bench.py``, the scripts under
``scripts/``) calls `require_gpu` first: a timing taken on the CPU says
nothing about the card, so a run that finds no GPU fails instead of falling
back. `card_line` records the card's name and power limit, because a card
set below its maximum power runs slower under load.
"""

from __future__ import annotations

import os
import subprocess

__all__ = ["require_gpu", "card_line", "device_record"]


def card_line() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports it."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def require_gpu():
    """Raise unless JAX's default backend is a GPU; return its devices."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"this measurement needs a GPU; JAX's default backend is {backend!r}"
        )
    return jax.devices()


def device_record() -> dict:
    """The device fields every result carries: platform, kind, count, card
    name and power limit, and the XLA flags in force."""
    import jax

    devs = require_gpu()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "card": card_line(),
        "jax": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
