"""Dotted-path symbol loading (reference: mettagrid_tpu/util/module.py).

Loads a symbol named by its dotted path, as the polymorphic configs (map
builders, MapGen scenes, policies) name their classes. Every dotted-path
resolver of the port goes through ``load_symbol``, which refuses paths into
the JAX package or the JAX stack before importing anything.
"""

from __future__ import annotations

import importlib
from typing import Any, Optional

# Top-level packages the port never loads: the JAX package and its stack.
REFUSED_PACKAGES = ("mettagrid_tpu", "jax", "flax", "optax")


def refuse_reference(path: str) -> None:
    """Raise ImportError if ``path`` names a module of the JAX package or the
    JAX stack. The path is not translated: a config written for the JAX
    package stays recognisably so."""
    head, _, rest = path.partition(".")
    if head not in REFUSED_PACKAGES:
        return
    if head == "mettagrid_tpu":
        counterpart = "mettagrid_tpu_torch" + (f".{rest}" if rest else "")
        raise ImportError(
            f"{path!r} names the JAX package; the PyTorch port loads its own counterpart {counterpart!r}"
        )
    raise ImportError(f"{path!r} names {head}, which the PyTorch port never imports; name a mettagrid_tpu_torch path")


def load_symbol(full_name: str, strict: bool = True) -> Optional[Any]:
    """Load 'pkg.module.Attr.Nested' by trying progressively shorter module
    prefixes, then walking the remaining attributes (an AttributeError moves
    on to the next shorter prefix). A path into the JAX package or the JAX
    stack raises ImportError first, strict or not."""
    refuse_reference(full_name)
    parts = full_name.split(".")
    if len(parts) < 2:
        raise ModuleNotFoundError(f"Invalid symbol name: {full_name}")

    last_error: Optional[Exception] = None
    for i in range(len(parts) - 1, 0, -1):
        module_name = ".".join(parts[:i])
        try:
            module = importlib.import_module(module_name)
        except ImportError as exc:
            last_error = exc
            continue
        try:
            value: Any = module
            for attr in parts[i:]:
                value = getattr(value, attr)
            return value
        except AttributeError:
            continue

    if strict:
        if last_error:
            raise last_error
        raise ModuleNotFoundError(f"Could not load symbol: {full_name}")
    return None
