"""Device ms per step of the kernels that start inside the step's
``step.aoe`` span (spans.span_times); nothing where the span did not run."""

SPAN = "step.aoe"


def read(ctx):
    trace = ctx.get("trace")
    span = (trace or {}).get("spans", {}).get(SPAN)
    if not span or span["device_ms"] <= 0:
        return None
    return span["device_ms"]
