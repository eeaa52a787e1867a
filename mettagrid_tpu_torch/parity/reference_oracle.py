"""Load the reference C++ engine as an external parity oracle.

The correctness target is bit-exact episode-signature parity with the
reference C++ engine. This module makes that engine (built by
scripts/build_reference_oracle.sh into build/reference/mettagrid_c.so from
the reference's sources) importable, so the parity runs
(parity/cross_engine.py, parity/arena.py) can step both engines on matched
configs and compare their states directly.

Nothing here runs unless the oracle was built; the oracle's tests skip
otherwise. Everything is looked for inside this checkout, in the git-ignored
build/reference/: the extension there, and the reference's sources in its
``src`` (place the reference's checkout at build/reference/src and run the
build script with REFERENCE_DIR set to that path). The C++ package
``mettagrid`` is imported only by load_reference.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_ORACLE_DIR = os.path.join(_REPO, "build", "reference")
_REFERENCE_PY = os.path.join(_ORACLE_DIR, "src", "python", "src")

# Where the reference's sources go and how the oracle is built from them.
HOW_TO_BUILD = (
    "place the reference's sources at build/reference/src, then run "
    "REFERENCE_DIR=build/reference/src scripts/build_reference_oracle.sh"
)

_loaded: Optional[bool] = None


def reference_available() -> bool:
    """Whether the oracle was built and the reference's Python sources are there."""
    return os.path.exists(os.path.join(_ORACLE_DIR, "mettagrid_c.so")) and os.path.isdir(_REFERENCE_PY)


def load_reference():
    """Import and return the reference `mettagrid` package (or raise).

    Installs sys.path entries for the built extension, the dependency shims,
    and the reference Python sources, and aliases the extension to
    `mettagrid.mettagrid_c` (the name the package expects from its Bazel
    build — reference BUILD.bazel pybind_extension "mettagrid_c").
    """
    global _loaded
    if not reference_available():
        raise RuntimeError(f"reference oracle not built — {HOW_TO_BUILD}")
    if _loaded is None:
        for p in (_ORACLE_DIR, os.path.join(_ORACLE_DIR, "shims"), _REFERENCE_PY):
            if p not in sys.path:
                sys.path.append(p)
        import mettagrid_c  # noqa: F401

        sys.modules.setdefault("mettagrid.mettagrid_c", mettagrid_c)
        _loaded = True
    import mettagrid as ref_mettagrid

    return ref_mettagrid


def reference_state_summary(ref_sim) -> Dict[str, Any]:
    """Canonical end-state summary of a reference Simulation, shaped like
    parity.signature.state_summary so the two engines diff directly.

    Uses grid_objects() (reference cpp/bindings/mettagrid_py.cpp:242-397
    exposure) + episode_rewards + per-agent stats. Orderings canonicalized
    (objects by (r, c, type), inventories by resource name, stats sorted) —
    the reference's unordered_map iteration order is not deterministic
    across builds (SURVEY.md §3.3).
    """
    import numpy as np

    objs = []
    for _oid, obj in sorted(ref_sim.grid_objects().items()):
        inv = obj.get("inventory", {}) or {}
        resource_names = ref_sim.resource_names
        objs.append(
            {
                "type": obj.get("type_name", obj.get("type")),
                "r": int(obj.get("r", obj.get("row", -1))),
                "c": int(obj.get("c", obj.get("col", -1))),
                "vibe": int(obj.get("vibe", 0)),
                "tags": sorted(obj.get("tags", []) or []),
                "inventory": {
                    (resource_names[k] if isinstance(k, int) else str(k)): int(v)
                    for k, v in sorted(inv.items(), key=lambda kv: str(kv[0]))
                    if int(v) != 0
                },
            }
        )
    objs.sort(key=lambda o: (o["r"], o["c"], str(o["type"])))
    return {
        "step": int(ref_sim.current_step),
        "objects": objs,
        "episode_rewards": [round(float(x), 6) for x in np.asarray(ref_sim.episode_rewards)],
    }
