"""Kernels B7's and B8's plain versions and the port's non-fused observation
path against the JAX engine, exactly.

The non-fused path serves configs that no fused tail takes: the AOE mask
(the ``territory`` bench variant, tools/bench_run.py) and window rows wider
than 128 lanes (OW * S > 128 with token values in base 4: the armed combat
config with a 15x15 window, S = 9, over a static background, and the
general config with its 13x13 window, S = 12, over a mutable one; a window
is at most 15 cells wide, since a location byte packs coordinates 0-14).
Each case is a real small state: E=4 envs stepped 6 times by the JAX
engine with random actions.

* B7 (window slices): the JAX engine's windows in Manhattan order, read
  through its ``_TAP = "win"`` hook (``window_slices_pallas`` has no
  interpret mode; on the CPU the reference extracts windows by two one-hot
  einsums), against ``window_slices_ref`` on the port's padded interleaved
  image.
* B8 (row compaction): ``compact_rows_ref`` against ``compact_rows_pallas``
  in interpret mode and ``compact_rows_xla``, with more candidates than the
  budget and fewer.
* The whole observation function against the JAX ``make_obs_fn``.

Tolerance: exact (integer token words; the reference's window einsums run
at HIGHEST precision on integer payloads below 2^16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mettagrid_tpu.engine as jengine
import mettagrid_tpu.engine.obs as jobs
from mettagrid_tpu.engine.pallas_kernels import compact_rows_pallas, compact_rows_xla
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.engine import obs as tobs
from mettagrid_tpu_torch.engine.interop import state_from_numpy
from mettagrid_tpu_torch.engine.kernels.compact_rows import compact_rows, compact_rows_ref
from mettagrid_tpu_torch.engine.kernels.window_slices import window_slices, window_slices_ref
from mettagrid_tpu_torch.engine.step import step_obs_fn
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from mettagrid_tpu_torch.tools import bench_run
from tests.test_torch_general import _build
from tests.test_torch_territory import jax_twin

E = 4
CASES = ("territory", "combat_15", "general_13")


def _port_cfg(case):
    if case == "territory":
        return bench_run.make_cfg("territory", 12)
    variant, window = case.split("_")
    cfg = bench_run.make_cfg(variant, 8)
    cfg.game.map_builder = RandomMapBuilder.Config(agents=8, width=15, height=15, border_width=1, objects={"wall": 8})
    cfg.game.obs.width = cfg.game.obs.height = int(window)
    cfg.game.obs.token_value_base = 4
    if variant == "combat":
        cfg.game.agent.inventory.initial = {"laser": 5, "armor": 1, "heart": 9}
    return cfg


_CASES = {}


def _case(case):
    """(JAX obs fn, port obs fn, JAX state after 6 random steps) of a case,
    built once per module."""
    if case not in _CASES:
        tcfg = _port_cfg(case)
        jp, ji = _build(jengine, jax_twin(tcfg), (3, 4))
        tp, ti = _build(tengine, tcfg, (3, 4))
        jfn = jobs.make_obs_fn(jp, jobs.build_static_bg(jp, ji) if jobs.static_background_ok(jp) else None)
        tfn = step_obs_fn(tp, ti, "cpu")
        state, _ = jengine.make_reset(jp, ji, E)(0)
        step = jengine.make_step(jp, ji, auto_reset=True, donate=False)
        rng = np.random.default_rng(5)
        A, n = jp.num_agents, len(jp.action_names)
        for _ in range(6):
            acts = jnp.asarray(rng.integers(0, n, (E, A)), dtype=jnp.int32)
            state, _ = step(state, acts, jnp.asarray(rng.integers(0, n, (E, A)), dtype=jnp.int32))
        _CASES[case] = (jfn, tfn, state)
    return _CASES[case]


def _port_state(jstate):
    return state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate._fields}, "cpu")


@pytest.mark.parametrize("case", CASES)
def test_case_takes_the_nonfused_route(case):
    """Each case leaves both fused tails: the AOE mask, or window rows wider
    than 128 lanes."""
    _, tfn, _ = _case(case)
    assert tfn.route == "nonfused" and tfn.tail is None
    tp = tengine.compile_program(_port_cfg(case))
    S = tobs.make_stage1(tp).num_slots
    if case == "territory":
        assert tp.feature_ids.aoe_mask and tp.territories
    else:
        assert tp.obs_width * S > 128


@pytest.mark.parametrize("case", CASES)
def test_window_slices_ref_matches_jax_windows(case, monkeypatch):
    """B7's plain version on the port's padded interleaved image returns the
    reference's windows in Manhattan order, every channel (token words,
    count and, with the AOE mask, the winning tag + 1)."""
    jfn, tfn, jstate = _case(case)
    monkeypatch.setattr(jobs, "_TAP", "win")
    ref, _ = jfn(jstate)
    args = tfn.window_inputs(_port_state(jstate))
    win = window_slices(**args)
    np.testing.assert_array_equal(win.numpy(), np.asarray(ref).astype(np.int32))
    np.testing.assert_array_equal(window_slices_ref(**args).numpy(), win.numpy())
    assert (win > 0).any()
    if case == "territory":
        assert set(np.unique(win[..., -1].numpy())) >= {0, 1, 2}, "no cell owned by each team"


@pytest.mark.parametrize("R,C,T", [(64, 200, 96), (32, 96, 128), (40, 971, 500)])
def test_compact_rows_ref_matches_pallas(R, C, T):
    """B8's plain version against the Pallas kernel in interpret mode and
    the XLA formulation: more candidates than the budget (C > T, where the
    budget truncates dense rows) and fewer (C < T)."""
    rng = np.random.default_rng(R + C)
    words = rng.integers(-1, 1 << 20, (R, C)).astype(np.int32)
    words[: R // 2] = np.where(rng.random((R // 2, C)) < 0.7, -1, words[: R // 2])  # sparse rows
    ref = np.asarray(compact_rows_pallas(jnp.asarray(words), T, block_rows=8, interpret=True))
    xla = np.asarray(compact_rows_xla(jnp.asarray(np.pad(words, ((0, 0), (0, max(0, T - C))), constant_values=-1)), T))
    np.testing.assert_array_equal(ref, xla)
    got = compact_rows(torch.from_numpy(words), T)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(compact_rows_ref(torch.from_numpy(words), T).numpy(), ref)


@pytest.mark.parametrize("case", CASES)
def test_obs_fn_matches_jax(case):
    """The port's whole non-fused observation function equals the JAX
    engine's observations and attempted counts; in the territory case both
    friendly and enemy AOE mask tokens appear."""
    jfn, tfn, jstate = _case(case)
    ref_obs, ref_att = jfn(jstate)
    obs, att = tfn(_port_state(jstate))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(ref_obs))
    np.testing.assert_array_equal(att.numpy(), np.asarray(ref_att))
    if case == "territory":
        o = obs.numpy()
        tp = tengine.compile_program(_port_cfg(case))
        vals = set(np.unique(o[..., 2][o[..., 1] == tp.feature_ids.aoe_mask]))
        assert vals == {1, 2}
