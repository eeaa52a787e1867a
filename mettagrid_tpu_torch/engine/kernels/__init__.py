"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""

import torch

captured = None  # the wrappers launched into the CUDA graph being captured (engine/step_graphs.py), else None


def count_launch(wrapper) -> None:
    """Adds one to ``wrapper.launches``, its kernel's launch count. A launch
    captured into a CUDA graph runs at each replay of the graph instead: it
    is noted in ``captured``, and engine/step_graphs.py adds one for each
    replay of the graph that holds it."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        if captured is not None:
            captured.append(wrapper)
    else:
        wrapper.launches += 1
