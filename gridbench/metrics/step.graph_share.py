"""Share of untraced steps replayed as CUDA graphs (the program's counter
``step.graph_replays`` over ``step.calls``, host_totals.py); nothing where
the program has no graph path."""

import importlib.util

from gridbench.metrics import host_totals


def read(ctx):
    if importlib.util.find_spec("mettagrid_tpu_torch.engine.step_graphs") is None:
        return None
    return host_totals.count_per_step(host_totals.totals(), "step.graph_replays")
