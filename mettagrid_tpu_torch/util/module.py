"""Dotted-path symbol loading (reference: mettagrid_tpu/util/module.py).

Loads a symbol named by its dotted path, as the polymorphic configs (map
builders, policies) name their classes.
"""

from __future__ import annotations

import importlib
from typing import Any, Optional


def load_symbol(full_name: str, strict: bool = True) -> Optional[Any]:
    """Load 'pkg.module.Attr.Nested' by trying progressively shorter module
    prefixes, then walking the remaining attributes."""
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
