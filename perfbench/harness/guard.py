"""The import guard: a run of the port may not load JAX or the JAX package.

Modules are compared by their top-level name (the part before the first
dot) whole, since the port's name, al26_tpu_torch, begins with the JAX
package's, al26_tpu.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "al26_tpu"})


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
