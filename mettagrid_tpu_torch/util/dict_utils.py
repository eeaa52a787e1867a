"""Nested-dict flattening (reference: mettagrid_tpu/util/dict_utils.py)."""

from __future__ import annotations

from typing import Any, Generator


def unroll_nested_dict(d: dict[str, Any]) -> Generator[tuple[str, Any], None, None]:
    """Yield ('a/b/c', leaf) pairs for a nested dict."""
    for k, v in d.items():
        if isinstance(v, dict):
            for k2, v2 in unroll_nested_dict(v):
                yield f"{k}/{k2}", v2
        else:
            yield k, v
