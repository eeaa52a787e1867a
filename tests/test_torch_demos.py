"""The port's demos on the CPU (twins of tests/test_demos.py): the A2C
training demo with few steps and the PettingZoo demo for one episode."""

import math

from mettagrid_tpu_torch.demos.demo_pettingzoo import run
from mettagrid_tpu_torch.demos.demo_train import train


def test_training_demo_runs():
    losses = train(num_envs=4, num_agents=2, steps=5, device="cpu")
    assert len(losses) == 5
    assert all(math.isfinite(x) for x in losses)
    assert len(set(losses)) > 1


def test_pettingzoo_demo_runs():
    totals = run(episodes=1, device="cpu")
    assert len(totals) == 1 and math.isfinite(totals[0])
