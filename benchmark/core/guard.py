"""The import guard: the run's process must hold none of JAX, its libraries
or the JAX package, compared by whole top-level module name (the port's
name begins with the JAX package's, so a prefix test would be wrong)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "unboundednerfpytorch_tpu"})


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__("modules that no run may load: " + ", ".join(names))
        self.names = names


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: every
    module this process has loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
