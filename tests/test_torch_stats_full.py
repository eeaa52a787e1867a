"""Inventory stats without compact stat storage, against the JAX engine,
exactly.

A ``stats`` mutation that writes an auto-family agent stat (``heart.gained``,
``death``, ...) turns compact stat storage off: the gained, lost, amount,
deposited and death families then live in ``agent_stats`` under regular ids,
and ``<res>.amount`` carries a touched bit. Three cases on the arena of
tests/test_torch_mutation_kinds.py, each stepped in lockstep with the JAX
engine's sequential phase for 10 steps under the port's wave phase and its
sequential phase, with auto-reset at step 6:
- ``gain``: a move handler that sets ``heart.gained``, then adds a heart;
  an agent on_tick reads ``heart.gained`` back through a Stat value;
- ``deposit``: agents hand ore to what they bump (``resource_transfer``,
  logging ``ore_red.deposited``), and an event changes every agent's
  inventory;
- ``death``: an ``hp`` resource that bumps drive to 0, and an event that
  heals.
Every output and state field is compared after every step, ``agent_stats``
and ``agent_stats_touched`` among them. Tolerance: exact (float stats that
are sums and copies of small integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mettagrid_tpu.engine as jengine
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.config.game_value import ConstValue, StatValue
from mettagrid_tpu_torch.config.handler_config import (
    EntityTarget,
    HandlerTarget,
    ResourceTransferMutation,
    StatsEntity,
    StatsMutation,
    StatsTarget,
)
from tests.test_torch_mutation_kinds import (
    E,
    _assert_equal,
    _base_cfg,
    _delta,
    _draws,
    _event,
    _has,
    _move,
    assert_inits_equal,
    jax_state_of,
)
from tests.test_torch_reference_rng import build_both

STEPS = 10
A_, T_ = EntityTarget.ACTOR, EntityTarget.TARGET


def _set(stat, source, entity=StatsEntity.ACTOR):
    return StatsMutation(stat=stat, target=StatsTarget.AGENT, entity=entity, source=source)


def _case(kind):
    cfg = _base_cfg()
    g = cfg.game
    g.max_steps = 6
    if kind == "gain":
        g.actions.move.handlers = [_move("gain", [_set("heart.gained", ConstValue(value=10)), _delta(A_, heart=1)])]
        g.agent.on_tick = _move("seen", [_set("gain_seen", StatValue(name="heart.gained"), StatsEntity.TARGET)])
    elif kind == "deposit":
        g.actions.move.handlers = [_move("give", [
            ResourceTransferMutation(from_target=A_, to_target=T_, resources={"ore_red": 1}),
            ResourceTransferMutation(from_target=T_, to_target=A_, resources={"heart": 1}),
            _set("ore_red.lost", StatValue(name="ore_red.deposited")),
        ], [_has(HandlerTarget.ACTOR, ore_red=1)])]
        g.events = {"feed": _event("feed", "agent", [_delta(T_, ore_red=2, heart=-1)], start=1, period=2)}
    elif kind == "death":
        g.resource_names = [*g.resource_names, "hp"]
        g.agent.inventory.initial = {**g.agent.inventory.initial, "hp": 2}
        g.actions.move.handlers = [_move("hit", [_delta(T_, hp=-1), _set("death", StatValue(name="death"))])]
        g.events = {"heal": _event("heal", "agent", [_delta(T_, hp=1)], start=3, period=3)}
    else:
        raise AssertionError(kind)
    return cfg


def _lockstep(cfg, mode):
    """Steps the JAX engine's sequential phase and the port's phase ``mode``
    ("auto": waves where the gate admits them; "sequential") from the port's
    reset with auto-reset on, comparing after every step, the port's grid
    with its agent layer rebuilt where its waves run gridless. Returns
    (port program, port step, port state)."""
    (jp, ji), (tp, ti) = build_both(cfg, [7])
    assert_inits_equal(ji, ti)
    jstep = jengine.make_step(jp, ji, auto_reset=True, donate=False, action_mode="sequential", external_perm=True)
    tstep = tengine.make_step(tp, ti, auto_reset=True, device="cpu", action_mode=mode, external_perm=True)
    lazy = tstep.lazy_grid
    tstate, tout = tengine.make_reset(tp, ti, E, device="cpu")(0)
    jstate, jbuf = jax_state_of(tstate), jnp.asarray(tout.observations.numpy())
    rng = np.random.default_rng(1)
    for i in range(STEPS):
        acts, vib, p = _draws(rng, len(tp.action_names))
        jstate, jout = jstep(jstate, jnp.asarray(acts), jnp.asarray(vib), jnp.asarray(p), jbuf)
        jbuf = jout.observations
        tstate, tout = tstep(tstate, torch.from_numpy(acts), torch.from_numpy(vib), torch.from_numpy(p),
                             tout.observations)
        _assert_equal(jstate, jout, tstate, tout, lazy, f"step {i}: ")
    return tp, tstep, tstate


@pytest.mark.parametrize("mode", ["auto", "sequential"])
@pytest.mark.parametrize("kind", ["gain", "deposit", "death"])
def test_inventory_stats_without_compact_storage(kind, mode):
    """The port equals the JAX engine on every field, and the families the
    case exercises were written."""
    tp, tstep, state = _lockstep(_case(kind), mode)
    assert not tp.stats_compact
    assert tstep.action_phase_kind == ("waves" if mode == "auto" else "sequential")
    stats, touched = state.agent_stats, state.agent_stats_touched
    heart = tp.resource_names.index("heart")
    if kind == "gain":
        # Set to 10 by the bump, then one more for the heart it adds.
        assert (stats[..., int(tp.stat_inv_gained[heart])] == 11).any()
        assert (stats[..., tp.agent_stat_names.index("gain_seen")] > 0).any()
    elif kind == "deposit":
        ore = tp.resource_names.index("ore_red")
        assert (stats[..., int(tp.stat_inv_deposited[ore])] > 0).any()
    else:
        assert (stats[..., tp.stat_death] > 0).any()
    a0 = int(tp.stat_inv_amount[heart])
    assert touched[..., a0].all()
