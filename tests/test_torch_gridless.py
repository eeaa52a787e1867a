"""One predicate for the gridless wave batch and the auto-reset merge skip.

The reference keys its auto-reset merge skip on ``gridless_batch_ok``
(mettagrid_tpu/engine/step.py:733), but runs a wave batch without the grid
only when every move handler but the last is also all-or-nothing
(actions_fast.py:428-436). A configured move handler whose UseTarget can
fail passes the first and not the second: the batch then writes the grid's
agent layer while the merge keeps the grid of the last episode. Pure-move
programs without a static background (an event that gives walls hearts)
also write the grid in their waves while gridless_batch_ok holds; there the
reference merges the grid anyway, because the event's inventory mutation
marks it written. The port keys the batch on ``actions_fast.batch_gridless``
and skips the grid in the merge only where the action phase writes no grid
cell: pure waves with the lazy grid, or gridless batches. With one pooled
map and
METTAGRID_TPU_NO_MERGE_SKIP=1, the reference merges every field, so it is
the right yardstick; the port must equal it field for field, and keep its
grid equal to the grid rebuilt from positions.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import mettagrid_tpu.builder as jbuilder
import mettagrid_tpu.config.event_config as jec
import mettagrid_tpu.config.handler_config as jhc
import mettagrid_tpu.engine as jengine
from mettagrid_tpu.engine.actions_fast import gridless_batch_ok as jax_gridless_batch_ok
from mettagrid_tpu.engine.exec import true_grid as jax_true_grid
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu_torch import builder as tbuilder
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.config import event_config as tec
from mettagrid_tpu_torch.config import handler_config as thc
from mettagrid_tpu_torch.config.tag import typeTag
from mettagrid_tpu_torch.engine.actions_fast import batch_gridless, gridless_batch_ok, pure_move_ok, shared_read_ok
from mettagrid_tpu_torch.engine.exec import true_grid
from mettagrid_tpu_torch.engine.step import step_gates
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from tests.test_torch_general import A, E, _build, _lockstep


def _cfgs(kind):
    """(JAX config, port config) of the arena with one change.

    poke: a configured move handler in front whose only mutation is a
    UseTarget (nothing is usable, so it always fails): the wave batches read
    and write the grid. bloom: an event that gives walls hearts: the moves
    stay pure, but the background is mutable, so the pure waves write the
    grid."""
    out = []
    for builder, hc, rmb, ec in (
        (jbuilder, jhc, JRandomMapBuilder, jec),
        (tbuilder, thc, RandomMapBuilder, tec),
    ):
        cfg = builder.make_arena(
            A, combat=False,
            map_builder=rmb.Config(agents=A, width=11, height=11, border_width=1, objects={"wall": 6}),
        )
        if kind == "poke":
            cfg.game.actions.move.handlers = [hc.Handler(name="poke", mutations=[hc.UseTargetMutation()])]
        else:
            cfg.game.events = {
                "bloom": ec.EventConfig(
                    name="bloom", target_query=typeTag("wall"), timesteps=ec.periodic(start=3, period=5),
                    max_targets=2, mutations=[hc.updateTarget({"heart": 1})],
                )
            }
        cfg.game.max_steps = 20
        out.append(cfg)
    return out


@pytest.mark.parametrize("kind", ["poke", "bloom"])
def test_gridless_batch_ok_holds_where_the_grid_is_written(kind):
    jcfg, tcfg = _cfgs(kind)
    jp, _ = _build(jengine, jcfg, (3,))
    tp, _ = _build(tengine, tcfg, (3,))
    assert jax_gridless_batch_ok(jp) and gridless_batch_ok(tp)
    if kind == "poke":
        assert not shared_read_ok(tp) and not batch_gridless(tp)
    else:
        assert pure_move_ok(tp) and not step_gates(tp).static_bg


@pytest.mark.parametrize("kind", ["poke", "bloom"])
def test_merge_skips_the_grid_only_where_no_phase_writes_it(kind, monkeypatch):
    """45 steps, every env resetting twice on a one-map pool: the port equals
    the reference without the merge skip, and its grid stays the true grid;
    for poke, the reference with its skip keeps a stale grid after a reset."""
    monkeypatch.setenv("METTAGRID_TPU_NO_MERGE_SKIP", "1")
    jcfg, tcfg = _cfgs(kind)

    def grid_is_true(jstate, tstate, tout):
        np.testing.assert_array_equal(tstate.grid.numpy(), true_grid(tstate, A).numpy())

    seen = _lockstep(jcfg, tcfg, 45, seeds=(3,), check=grid_is_true)
    assert seen["resets"] == 2 * E
    if kind != "poke":
        return

    # The reference with its merge skip: after the resets at step 21, the
    # grid still holds agents where the last episode left them.
    monkeypatch.delenv("METTAGRID_TPU_NO_MERGE_SKIP")
    jp, ji = _build(jengine, jcfg, (3,))
    state, _ = jengine.make_reset(jp, ji, E)(0)
    step = jengine.make_step(jp, ji, auto_reset=True, donate=False)
    rng = np.random.default_rng(0)
    for _ in range(21):
        state, _ = step(state, jnp.asarray(rng.integers(1, 5, (E, A)), dtype=jnp.int32), jnp.zeros((E, A), jnp.int32))
    assert int(state.step_count.max()) == 1
    assert not np.array_equal(np.asarray(state.grid), np.asarray(jax_true_grid(state, A)))
