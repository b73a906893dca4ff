"""The import guard: top-level module names a run must not have loaded.

Names are compared whole (the part before the first dot), so the port,
``llama_gguf_tpu_torch``, is not the JAX package, ``llama_gguf_tpu``.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "llama_gguf_tpu"})


def loaded(modules=None, forbidden=FORBIDDEN) -> list[str]:
    """The forbidden top-level names among ``modules`` (sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & forbidden)
