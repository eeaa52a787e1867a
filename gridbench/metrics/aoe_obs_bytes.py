"""The least memory traffic of one step's observations with the AOE mask,
counted from the cell's shapes, the tokens the step hands back and the
configuration file, never from a kernel's arguments.

``obs_bytes.obs_bytes`` with the tags the file gives (``type:<t>`` of every
type and each type's own tags), plus what the mask is made of, read once:
each emitting source's position (2), strength, decay and tag (4 bytes each)
in every env. A source emits where its type controls a territory; the map's
``objects`` give how many there are.
"""

from __future__ import annotations

from gridbench.metrics.obs_bytes import obs_bytes

SOURCE_BYTES = 4 * (2 + 1 + 1 + 1)


def tags(spec: dict) -> int:
    types = {"agent": spec["agent"], **spec["objects"]}
    return len({f"type:{t}" for t in types} | {g for c in types.values() for g in c.get("tags", ())})


def sources(spec: dict) -> int:
    """Emitting sources per map."""
    return sum(n for name, n in spec["map"]["objects"].items()
               if spec["objects"].get(name, {}).get("territory_controls"))


def aoe_obs_bytes(spec: dict, envs: int, agents: int, objects: int, pool: int, resources: int, tokens: int,
                  static_background: bool) -> int:
    return (obs_bytes(envs, agents, objects, pool, resources, tags(spec), tokens, static_background)
            + envs * sources(spec) * SOURCE_BYTES)
