"""The least memory traffic of one step's observations, counted from the
cell's shapes and the tokens the step hands back, never from a kernel's
arguments: the same work whatever implements it.

Written once: each token the observations hold (3 bytes; the rest of the
buffer keeps its 0xFF bytes). Read once: what the tokens are made of, each
field as 4 bytes (a bool as 1): per env its step count and map; per agent its
position, type, vibe, group, last action, reward, inventory and tags; the
other objects per env, or, where the configuration's background is static
(no action, event or handler writes a non-agent object), once per pool map.
Operations are a handful per byte, far under the chip's rate, so the bytes
bound the time.
"""

from __future__ import annotations

from gridbench.metrics.peaks import H100_SXM


def object_bytes(resources: int, tags: int) -> int:
    """Position (2), type, vibe, inventory (4 bytes each), tags and alive (1 each)."""
    return 4 * (2 + 1 + 1 + resources) + tags + 1


def agent_bytes(resources: int, tags: int) -> int:
    """An object's bytes plus group, last action and reward (4 each)."""
    return object_bytes(resources, tags) + 4 * 3


def obs_bytes(envs: int, agents: int, objects: int, pool: int, resources: int, tags: int, tokens: int,
              static_background: bool) -> int:
    """Bytes one step's observations need: ``tokens`` written (3 bytes
    each), the rest read once. ``objects`` counts every object slot, agents
    included."""
    others = (objects - agents) * object_bytes(resources, tags)
    read = envs * (8 + agents * agent_bytes(resources, tags)) + (pool if static_background else envs) * others
    return 3 * tokens + read


def least_seconds(n_bytes: int) -> float:
    return n_bytes / H100_SXM["hbm_bytes_per_s"]
