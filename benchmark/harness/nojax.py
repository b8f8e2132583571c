"""The modules a run may not hold: JAX and the JAX package the port was
made from. Names are compared by their top-level part, whole: the port's
own package name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gol_distributed_final_tpu"})


def loaded(modules=None) -> list[str]:
    """The forbidden modules in ``modules`` (``sys.modules`` by default)."""
    names = sys.modules if modules is None else modules
    return sorted(name for name in names if name.partition(".")[0] in FORBIDDEN)
