"""Percent of the observations' least time (obs_bytes: the bytes they need
over the card's 3.35 TB/s; bytes bound it) in the device time of the
``step.obs`` span."""

from gridbench.metrics.obs_bytes import least_seconds, obs_bytes


def read(ctx):
    span = ((ctx.get("trace") or {}).get("spans") or {}).get("step.obs")
    if not span or span["device_ms"] <= 0 or ctx.get("tokens_emitted") is None:
        return None
    n_bytes = obs_bytes(tokens=ctx["tokens_emitted"], **ctx["shapes"])
    return 100.0 * least_seconds(n_bytes) / (span["device_ms"] / 1e3)
