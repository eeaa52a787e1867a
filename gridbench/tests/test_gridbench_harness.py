"""The harness: cells resolve by name, the traffic repeats, the yardstick's
arithmetic, the refusal without a card, and ``correct`` against the control
and the faults a run can have (on the CPU at a small size)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gridbench import check, run, traffic
from gridbench.control import identity_order
from gridbench.metrics.obs_bytes import obs_bytes

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"envs": 8, "pool": 3, "check_envs": 8}


def test_every_cell_resolves_to_its_files():
    bench = run.load_benchmark()
    assert bench["workloads"]
    for cell in bench["workloads"]:
        r = run.resolve(bench, cell["name"])
        assert (ROOT / r["config"]["file"]).is_file()
        assert (ROOT / "gridbench" / "configs" / f"{r['config']['name']}.py").is_file()
        assert r["traffic"]["warmup_steps"] > 0 and r["traffic"]["trace_steps"] > 0
        assert hasattr(run.reference_module(r["spec"]["game"]), "Arena")
        assert (ROOT / "gridbench" / "reference" / "maps" / f"{r['spec']['map']['kind']}.py").is_file()
        e2e = {m["name"] for m in r["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) > 1
        assert r["per_layer"]
        for m in r["per_layer"]:
            assert callable(run.reader(m["name"]))
            assert m["moves"] in e2e


ACTIONS = ["noop", "move_north", "move_south", "move_west", "move_east"]


def _traffic(seed, mix="random_long", **params):
    return traffic.Traffic({**traffic.load(mix), **params}, seed, 16, 24, ACTIONS, 64, "cpu")


def _draws(seed, steps=3):
    gen = _traffic(seed)
    return [torch.cat([t.flatten() for t in gen.draw()]) for _ in range(steps)]


def test_traffic_repeats_for_a_seed():
    a, b, c = _draws(2**31 + 5), _draws(2**31 + 5), _draws(2**31 + 6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    acts, vibes, perm, maps = _traffic(9, "random_short").draw()
    assert acts.min() >= 0 and acts.max() < 5 and maps.min() >= 0 and maps.max() < 64
    assert set(acts.unique().tolist()) == set(range(5)) and not vibes.any()
    assert torch.equal(perm.sort(dim=1).values, torch.arange(24, dtype=torch.int32).expand(16, 24))


def test_traffic_follows_its_weights():
    gen = _traffic(3, action_weights={"noop": 1, "move_east": 3}, vibe_action_weights={"move_north": 1})
    acts, vibes, _, _ = (torch.stack(t) for t in zip(*(gen.draw() for _ in range(50))))
    assert set(acts.unique().tolist()) == {0, 4}
    assert 0.70 < (acts == 4).double().mean() < 0.80
    assert (vibes == 1).all()
    with pytest.raises(ValueError):
        _traffic(3, action_weights={"attack": 1})
    with pytest.raises(ValueError):
        traffic.Traffic({**traffic.load("random_long"), "action_weights": {"noop": 0}}, 3, 2, 2, ACTIONS, 1, "cpu")


def test_replay_gives_what_was_drawn():
    rows = torch.tensor([1, 5])
    gen = _traffic(21)
    drawn = [gen.draw() for _ in range(2)]
    again = _traffic(21).replay(2, rows)
    assert sorted(again) == ["actions", "perm", "reset_maps", "vibe_actions"]
    for i in range(2):
        for k, t in zip(("actions", "vibe_actions", "perm", "reset_maps"), drawn[i]):
            assert (again[k][i] == t[rows].numpy()).all()


def test_a_result_no_group_names_is_compared():
    ref = {"step_count": np.zeros(2), "inventory": np.ones((2, 3)), "pool_maps": np.array([["wall", "empty"]])}
    got = {"step_count": np.zeros(2), "pool_maps": np.array([["wall", "wall"]])}
    numbers = check.compare(ref, got)
    assert numbers["inventory"] == 6 and numbers["maps"] == 1 and numbers["episode_ends"] == 0
    assert check.wrong_envs(ref, got) == 2


def test_obs_bytes_of_a_tiny_shape():
    # object: 4 * (2 + 1 + 1 + 1) + 1 tag + 1 alive = 22 bytes; agent: 22 + 12 = 34.
    # Per env 8 + 34; the two other objects 44 bytes, once per pool map when static.
    assert obs_bytes(envs=2, agents=1, objects=3, pool=1, resources=1, tags=1, tokens=5,
                     static_background=True) == 3 * 5 + 2 * (8 + 34) + 1 * 44
    assert obs_bytes(envs=2, agents=1, objects=3, pool=1, resources=1, tags=1, tokens=5,
                     static_background=False) == 3 * 5 + 2 * (8 + 34) + 2 * 44


def test_window_metrics_take_every_step():
    steady = [10.0] * 19
    stalled = [10.0] * 18 + [200.0]
    calm, stall = (run.window_metrics(4096, len(g), sum(g) / 1e3, g) for g in (steady, stalled))
    assert calm["step_ms_p95"] == 10.0 and calm["env_steps_per_s"] == pytest.approx(4096 / 0.010)
    assert stall["step_ms_p95"] > 100.0
    assert stall["env_steps_per_s"] == pytest.approx(4096 * 19 / 0.380)


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "-m", "gridbench.run", "--workload", "arena.random_long", "--seed", "1",
                          "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _cpu_run(cell="arena.random_long", seed=11, **hooks):
    tov = {"max_steps": 6} if cell == "arena.random_short" else {}
    return run.run_cell(cell, seed, 0.5, False, device="cpu", spec_overrides=SMALL, traffic_overrides=tov, **hooks)


@pytest.mark.parametrize("cell", ["arena.random_long", "arena.random_short"])
def test_sound_run_is_correct(cell):
    res = _cpu_run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())


def state_unchanged(step):
    def broken(state, *args):
        _, out = step(state, *args)
        return state, out
    return broken


def half_the_batch(step):
    """Steps only the first half of the envs; the rest keep their state."""
    def broken(state, *args):
        new, out = step(state, *args)
        half = state.step_count.shape[0] // 2
        kept = {f: torch.cat([getattr(new, f)[:half], getattr(state, f)[half:]]) for f in state._fields}
        return new._replace(**kept), out
    return broken


def token_altered(step):
    def broken(state, *args):
        new, out = step(state, *args)
        obs = out.observations.clone()
        obs[:, :, 0, 2] ^= 1  # the first token's value of every agent
        return new, out._replace(observations=obs)
    return broken


@pytest.mark.parametrize("fault", ["control", "state_unchanged", "half_the_batch", "token_altered"])
def test_a_broken_run_is_not_correct(fault):
    hooks = {"feed": identity_order} if fault == "control" else {"wrap_step": globals()[fault]}
    res = _cpu_run(**hooks)
    assert not res["correct"]
    assert res["failed"] > 0
    assert json.dumps(res)  # the result stays printable


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "gridbench.run", "--workload", "arena.random_long", "--seed",
                          str(2**31 + 11), "--seconds", "2"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_busy_time_and_idle_gaps_by_host_span():
    from gridbench.metrics.spans import busy_and_gaps

    device = [(0, 10), (5, 20), (30, 40), (100, 110)]  # us; the first two overlap
    host = [(0, 25, "step.actions"), (25, 50, "step.obs")]
    busy, gaps = busy_and_gaps(device, host)
    assert busy == pytest.approx(40e-6)
    assert gaps == {"step.obs": pytest.approx(10e-6), "outside step spans": pytest.approx(60e-6)}
