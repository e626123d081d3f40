"""The check that no module of JAX or of the JAX package is loaded.

A module counts by its top-level name, the part before the first dot,
compared whole: ``fer_vit_tpu_torch`` is the port and passes, though its
name begins with the JAX package's.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fer_vit_tpu"})


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names}
                  & FORBIDDEN)
