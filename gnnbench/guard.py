"""The import guard: the benchmark measures the PyTorch port, and nothing
it runs may load JAX or the JAX package.  Module names are compared by
their top-level name (the part before the first dot), whole: the port's
own name begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpugraph"})


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (``sys.modules`` by default) whose top-level name
    is forbidden, sorted."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
