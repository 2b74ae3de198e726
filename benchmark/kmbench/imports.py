"""The check that a run loaded nothing of JAX or of the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "km_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names of loaded modules that are forbidden, compared
    whole: ``km_tpu_torch`` is not ``km_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
