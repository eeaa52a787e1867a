"""The readers of the program's own counts and host times
(metrics/host_totals.py): their arithmetic on a hand-made snapshot of the
totals, None where the totals are empty or the program has no recorder, and
a traced run on the CPU that reports all of them."""

import sys

import pytest

from gridbench import run
from gridbench.metrics import host_totals

MS = 1_000_000
SNAPSHOT = {
    "setup.make_reset": {"count": 1, "ns": 500 * MS, "child_ns": 0},
    "setup.make_step": {"count": 1, "ns": 1500 * MS, "child_ns": 0},
    "setup.reset": {"count": 1, "ns": 250 * MS, "child_ns": 0},
    "setup.first_step": {"count": 1, "ns": 750 * MS, "child_ns": 0},
    "step.calls": {"count": 10, "ns": 0, "child_ns": 0},
    "step": {"count": 10, "ns": 90 * MS, "child_ns": 70 * MS},
    "step.actions": {"count": 10, "ns": 50 * MS, "child_ns": 20 * MS},
    "step.obs": {"count": 10, "ns": 20 * MS, "child_ns": 0},
    "sync.actions.pure_waves": {"count": 30, "ns": 20 * MS, "child_ns": 0},
    "sync.mt.twist": {"count": 5, "ns": 5 * MS, "child_ns": 0},
    "host_syncs": {"count": 35, "ns": 0, "child_ns": 0},
    "host_syncs.actions.pure_waves": {"count": 30, "ns": 0, "child_ns": 0},
    "host_syncs.mt.twist": {"count": 5, "ns": 0, "child_ns": 0},
    "actions.waves": {"count": 40, "ns": 0, "child_ns": 0},
}
EXPECTED = {
    "step.host_syncs": 3.5,
    "actions.waves": 4.0,
    "step.sync_wait_ms": 2.5,
    "step.host_ms": 6.5,
    "actions.host_ms": 3.0,
    "setup.step_build_s": 2.25,
    "setup.first_step_s": 0.75,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_arithmetic(name, monkeypatch):
    monkeypatch.setattr(host_totals, "totals", lambda: SNAPSHOT)
    assert run.reader(name)({}) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_from_empty_totals(name, monkeypatch):
    monkeypatch.setattr(host_totals, "totals", dict)
    assert run.reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_without_the_recorder(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "mettagrid_tpu_torch.profiling.trace", None)
    assert host_totals.totals() == {}
    assert run.reader(name)({}) is None


def test_a_step_that_counted_nothing_reads_zero():
    t = {"step.calls": {"count": 4, "ns": 0, "child_ns": 0}, "step": {"count": 4, "ns": 8 * MS, "child_ns": 0}}
    assert host_totals.count_per_step(t, "host_syncs") == 0.0
    assert host_totals.sync_wait_ms(t) == 0.0 and host_totals.step_host_ms(t) == 2.0
    assert host_totals.self_ms(t, "step.actions") is None


def test_a_traced_cpu_run_reports_every_host_metric():
    from mettagrid_tpu_torch.profiling import trace

    trace.reset()
    res = run.run_cell("arena.random_long", 2**31 + 3, 0.5, True, device="cpu",
                       spec_overrides={"envs": 8, "pool": 3, "check_envs": 8})
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(EXPECTED) <= set(m)
    # Every step of the arena moves someone; the pure-move loop reads the
    # device once per wave from the second on, and the auto-reset merge
    # copies two tables from host memory (a pool of 3 maps).
    assert m["step.host_syncs"] - m["actions.waves"] == pytest.approx(1.0)
    assert m["actions.waves"] >= 2
    assert 0 < m["actions.host_ms"] < m["step.host_ms"]
    assert m["step.sync_wait_ms"] >= 0 and m["setup.step_build_s"] > 0 and m["setup.first_step_s"] > 0
