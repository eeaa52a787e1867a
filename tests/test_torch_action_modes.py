"""make_step's forced action modes in the port against the JAX engine.

The twin of tests/test_actions_fast.py::test_pure_move_matches_sequential:
the port's forced wave phases ("pure": pure-move waves, "fast":
handler-chain waves) step in lockstep with the JAX engine's sequential phase
on the CPU, both started from the JAX reset state and fed the same actions
and agent orders drawn with numpy. Every output and every state field but
``rng`` must be equal after every step (exact; the grid through
``true_grid`` where the agent layer is lazy).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mettagrid_tpu.builder as jbuilder
import mettagrid_tpu.engine as jengine
from mettagrid_tpu.engine.exec import true_grid as jax_true_grid
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu_torch import builder as tbuilder
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.engine.actions_fast import fast_mode_ok, pure_move_ok
from mettagrid_tpu_torch.engine.exec import true_grid
from mettagrid_tpu_torch.engine.interop import state_from_numpy, state_to_numpy
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder

A = 6
E = 8
STEPS = 15
OUTPUTS = ("observations", "tokens_attempted", "rewards", "terminals", "truncations", "action_success")


def _build(eng, builder_mod, rmb, size):
    cfg = builder_mod.make_arena(
        A, combat=False,
        map_builder=rmb.Config(agents=A, width=size, height=size, border_width=1, objects={"wall": 4}),
    )
    program = eng.compile_program(cfg)
    b = cfg.game.map_builder.create()
    b.config.seed = 7
    return program, eng.build_env_init(program, [b.build_for_num_agents(A)])


@pytest.mark.parametrize("mode", ["pure", "fast"])
@pytest.mark.parametrize("density", ["sparse", "dense"])
def test_forced_waves_match_jax_sequential(density, mode):
    size = 16 if density == "sparse" else 7
    jp, ji = _build(jengine, jbuilder, JRandomMapBuilder, size)
    tp, ti = _build(tengine, tbuilder, RandomMapBuilder, size)
    assert pure_move_ok(tp) and fast_mode_ok(tp)
    jstate, jout = jengine.make_reset(jp, ji, E)(0)
    jstep = jengine.make_step(jp, ji, auto_reset=False, donate=False, action_mode="sequential", external_perm=True)
    tstep = tengine.make_step(tp, ti, auto_reset=False, external_perm=True, action_mode=mode, device="cpu")
    assert tstep.action_phase_kind == "waves"
    # "pure" on the static background takes the lazy grid; "fast" runs the
    # handler-chain waves, whose batches are gridless on this config.
    assert tstep.lazy_grid
    tstate = state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate._fields}, "cpu")
    n_actions = len(jp.action_names)
    rng = np.random.default_rng(3)
    moved = 0
    for t in range(STEPS):
        acts = rng.integers(0, n_actions, (E, A)).astype(np.int32)
        vibes = np.zeros((E, A), np.int32)
        perm = np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32)
        prev_r = np.asarray(jstate.obj_r)[:, :A].copy()
        jstate, jout = jstep(jstate, jnp.asarray(acts), jnp.asarray(vibes), jnp.asarray(perm))
        tstate, tout = tstep(tstate, torch.from_numpy(acts), torch.from_numpy(vibes), torch.from_numpy(perm))
        moved += int((np.asarray(jstate.obj_r)[:, :A] != prev_r).sum())
        for f in OUTPUTS:
            np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                                          err_msg=f"step {t} {f}")
        port = state_to_numpy(tstate)
        for f in jstate._fields:
            if f == "rng":
                continue
            ref = np.asarray(getattr(jstate, f))
            got = port[f]
            if f == "grid":
                ref = np.asarray(jax_true_grid(jstate, A))
                got = true_grid(tstate, A).numpy()
            np.testing.assert_array_equal(got, ref, err_msg=f"step {t} {f}")
    assert moved > 0


@pytest.mark.parametrize("mode,kind,lazy", [("auto", "waves", True), ("pure", "waves", True),
                                            ("fast", "waves", True), ("sequential", "sequential", False)])
def test_action_mode_reported(mode, kind, lazy):
    """step.action_phase_kind and step.lazy_grid say what each mode chose."""
    tp, ti = _build(tengine, tbuilder, RandomMapBuilder, 7)
    step = tengine.make_step(tp, ti, action_mode=mode, device="cpu")
    assert step.action_phase_kind == kind
    assert step.lazy_grid is lazy


@pytest.mark.parametrize("mode", ["fast", "pure"])
def test_forced_waves_yield_to_twin_draws(mode):
    """Under reference_rng, action handlers that draw from the twin (the tithe
    family's order_by=random query) take the sequential phase whatever the
    mode, as in the reference (use_fast is false when actions consume the RNG)."""
    from mettagrid_tpu_torch.engine.rng_dep import actions_consume_rng
    from mettagrid_tpu_torch.tools.bench_run import build_pool, make_cfg

    program, init = build_pool(make_cfg("tithe_rrng", num_agents=4), 1)
    assert actions_consume_rng(program)
    step = tengine.make_step(program, init, reference_rng=True, action_mode=mode, device="cpu")
    assert step.action_phase_kind == "sequential" and not step.lazy_grid


def test_unknown_action_mode_raises():
    tp, ti = _build(tengine, tbuilder, RandomMapBuilder, 7)
    with pytest.raises(ValueError, match="action_mode"):
        tengine.make_step(tp, ti, action_mode="parallel", device="cpu")
