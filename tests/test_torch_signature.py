"""The port's episode signature and stats export against the JAX package's.

Both engines step in lockstep under the reference-RNG step from one seed
(tests/test_torch_reference_rng.py), and after every step the port's
``state_summary``, ``episode_signature``, ``episode_stats`` and
``merged_agent_rows`` of every env must equal the JAX package's on the JAX
state (tolerance: exact; the summaries hold integers and sums of small
integers rounded to 6 digits). One config with compact stat storage (the
flagship arena) and one without (a ``stats`` mutation that writes
``heart.gained``, tests/test_torch_stats_full.py). Then the signature tool
prints one hash in two fresh processes.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from mettagrid_tpu.parity.signature import episode_signature as jax_signature
from mettagrid_tpu.parity.signature import state_summary as jax_summary
from mettagrid_tpu.simulator.stats import episode_stats as jax_episode_stats
from mettagrid_tpu.simulator.stats import merged_agent_rows as jax_merged_rows
from mettagrid_tpu_torch.parity import episode_signature, state_summary
from mettagrid_tpu_torch.simulator.stats import episode_stats, merged_agent_rows
from tests.test_torch_reference_rng import build_both, lockstep, small_cfg
from tests.test_torch_stats_full import _case

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _configs(kind):
    if kind == "compact":
        return small_cfg("flagship", 4, 11, 0), [3]
    cfg = _case("gain")
    cfg.game.max_steps = 0
    return cfg, [7]


@pytest.mark.parametrize("kind", ["compact", "full"])
def test_signature_equals_jax(kind):
    cfg, seeds = _configs(kind)
    both = build_both(cfg, seeds)
    jp, tp = both[0][0], both[1][0]
    assert tp.stats_compact == (kind == "compact")
    E = 3
    seen = set()

    def each(jstate, tstate):
        for env in range(E):
            assert state_summary(tp, tstate, env) == jax_summary(jp, jstate, env)
            sig = episode_signature(tp, tstate, env)
            assert sig == jax_signature(jp, jstate, env)
            assert episode_stats(tp, tstate, env) == jax_episode_stats(jp, jstate, env)
            assert merged_agent_rows(tp, tstate, env) == [
                [(n, float(v), bool(t)) for n, v, t in row] for row in jax_merged_rows(jp, jstate, env)
            ]
            seen.add(sig)

    state = lockstep(*both, E=E, n_steps=8, each=each)
    assert len(seen) > E, "the signatures did not change as the episodes ran"
    summary = state_summary(tp, state, 0)
    assert summary["step"] == 8 and summary["objects"] and summary["agent_stats"][0]
    if kind == "full":
        assert any("heart.gained" in a for s in range(E) for a in state_summary(tp, state, s)["agent_stats"])


def test_tool_prints_one_hash_across_processes():
    cmd = [sys.executable, "-m", "mettagrid_tpu_torch.tools.episode_signature", "--device=cpu", "--steps=16"]
    hashes = set()
    for _ in range(2):
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        lines = res.stdout.split()
        assert len(lines) == 1 and len(lines[0]) == 64
        hashes.add(lines[0])
    assert len(hashes) == 1, hashes
