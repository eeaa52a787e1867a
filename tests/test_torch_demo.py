"""The port's demo CLI (``python -m mettagrid_tpu_torch.demo``), on the CPU:
it runs a rendered random-policy episode of the arena preset with
``--device=cpu``, and without a CUDA device and without ``--device`` it
raises instead of falling back to the CPU."""

import io
from contextlib import redirect_stdout

import pytest
import torch

from mettagrid_tpu_torch.demo import main


def test_demo_runs_on_cpu_with_render():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["--device=cpu", "--steps=8", "--render", "--agents=4"]) == 0
    out = buf.getvalue()
    assert "step 8/8" in out and "=== episode end ===" in out
    assert out.strip().splitlines()[-1].startswith("episode finished: steps=8 ")


def test_demo_needs_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--steps=2"])
