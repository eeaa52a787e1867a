"""Percent of the observations' least time (aoe_obs_bytes: the bytes they
need, the AOE mask's inputs included, over the card's 3.35 TB/s; bytes bound
it) in the device time of the ``step.obs`` span, for the territory
configuration (configs/territory.json)."""

import json
from pathlib import Path

from gridbench.metrics.aoe_obs_bytes import aoe_obs_bytes
from gridbench.metrics.obs_bytes import least_seconds

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "territory.json"


def read(ctx):
    span = ((ctx.get("trace") or {}).get("spans") or {}).get("step.obs")
    if not span or span["device_ms"] <= 0 or ctx.get("tokens_emitted") is None:
        return None
    shapes = {k: v for k, v in ctx["shapes"].items() if k != "tags"}
    n_bytes = aoe_obs_bytes(json.loads(CONFIG.read_text()), tokens=ctx["tokens_emitted"], **shapes)
    return 100.0 * least_seconds(n_bytes) / (span["device_ms"] / 1e3)
