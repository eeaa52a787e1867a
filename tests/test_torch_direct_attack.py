"""direct_attack where armor and health are one resource.

The dense form reads every target's armor once, before any hit. Where
armor is the health resource a second hit on the same target must meet the
armor the first hit lowered, so the port takes one gather/scatter hit per
batch column, in order (handlers._direct_attack_in_order). Held here:
- at the handler level, a batch whose two attackers hit one target equals
  the two hits applied one after another, as the sequential action phase
  applies them, and the damage computed by hand;
- on the combat config with armor = health = heart (agents start with a
  laser of 12 and 9 hearts), the wave phase equals the sequential phase
  (engine/actions.py) on every field, and both engines' sequential phases
  agree.
Tolerance: exact (integer inventories and stats).
"""

import numpy as np
import torch

from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.config.handler_config import DirectAttackMutation
from mettagrid_tpu_torch.engine.actions_fast import fast_mode_ok
from mettagrid_tpu_torch.engine.exec import Ctx, true_grid
from mettagrid_tpu_torch.engine.handlers import apply_mutation
from mettagrid_tpu_torch.engine.interop import state_to_numpy
from tests.test_torch_reference_rng import build_both, lockstep, small_cfg

A = 6


def _armor_is_health_cfg(size=7):
    cfg = small_cfg("combat", A, size, 0)
    cfg.game.actions.move.handlers[0].mutations = [
        DirectAttackMutation(weapon_resource="laser", armor_resource="heart", health_resource="heart")
    ]
    cfg.game.agent.inventory.initial = {"laser": 12, "armor": 1, "heart": 9}
    return cfg


def _program_state(E):
    cfg = _armor_is_health_cfg()
    cfg.game.map_builder.objects = {"wall": 4}
    program = tengine.compile_program(cfg)
    b = cfg.game.map_builder.create()
    b.config.seed = 7
    init = tengine.build_env_init(program, [b.build_for_num_agents(A)])
    return program, init


def test_repeated_target_meets_lowered_armor():
    E = 4
    program, init = _program_state(E)
    state, _ = tengine.make_reset(program, init, E, device="cpu")(0)
    (m,) = program.move_handlers[0].handler.mutations
    assert m.kind == "direct_attack" and m.armor_rid == m.health_rid
    heart, laser = m.health_rid, m.weapon_rid
    inv = state.obj_inv.clone()
    inv[:, :A, laser] = 12
    inv[:, :A, heart] = 10
    state = state._replace(obj_inv=inv)

    def ctx(actor, target):
        z = torch.zeros_like(target)
        return Ctx(actor=actor, target=target, target_r=z, target_c=z, distance=z,
                   timestep=torch.zeros((E,), dtype=torch.int32))

    # Agents 0 and 1 both hit agent 2; agent 3 hits agent 4 once.
    actor = torch.tensor([[0, 1, 3]] * E, dtype=torch.int32)
    target = torch.tensor([[2, 2, 4]] * E, dtype=torch.int32)
    mask = torch.ones((E, 3), dtype=torch.bool)
    mask[3, 1] = False  # env 3: one hit on agent 2
    batch, _ = apply_mutation(program, state, ctx(actor, target), m, mask)
    one_by_one = state
    for b in range(3):
        one_by_one, _ = apply_mutation(program, one_by_one, ctx(actor[:, b], target[:, b]), m, mask[:, b])
    for f in ("obj_inv", "auto_stats"):
        np.testing.assert_array_equal(getattr(batch, f).numpy(), getattr(one_by_one, f).numpy(), err_msg=f)
    # 10 hearts: the first hit deals 12 - 10 = 2, the second 12 - 8 = 4.
    np.testing.assert_array_equal(batch.obj_inv[:, 2, heart].numpy(), [4, 4, 4, 8])
    np.testing.assert_array_equal(batch.obj_inv[:, 4, heart].numpy(), [8] * E)


def test_waves_match_sequential_phase():
    """16 envs, 15 steps on dense 7x7 maps with random vibe actions, so
    angry agents bump and hit each other."""
    E = 16
    program, init = _program_state(E)
    assert fast_mode_ok(program)
    steps = {mode: tengine.make_step(program, init, auto_reset=False, device="cpu", external_perm=True,
                                     action_mode=mode) for mode in ("auto", "sequential")}
    assert steps["auto"].action_phase_kind == "waves"
    reset = tengine.make_reset(program, init, E, device="cpu")
    states = {mode: reset(0)[0] for mode in steps}
    heart0 = int(states["auto"].obj_inv[:, :A, program.resource_names.index("heart")].sum())
    rng = np.random.default_rng(0)
    n_actions = len(program.action_names)
    angry = program.action_names.index("change_vibe_angry")
    for t in range(15):
        acts = torch.from_numpy(rng.integers(1, 5, (E, A)).astype(np.int32))
        vibes = torch.from_numpy(np.where(rng.random((E, A)) < 0.5, angry, rng.integers(0, n_actions, (E, A))).astype(np.int32))
        perm = torch.from_numpy(np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32))
        outs = {}
        for mode, step in steps.items():
            states[mode], outs[mode] = step(states[mode], acts, vibes, perm)
        for name in outs["auto"]._fields:
            np.testing.assert_array_equal(getattr(outs["auto"], name).numpy(), getattr(outs["sequential"], name).numpy(),
                                          err_msg=f"step {t}: {name}")
    waves, seq = state_to_numpy(states["auto"]), state_to_numpy(states["sequential"])
    waves["grid"] = true_grid(states["auto"], A).numpy()
    for name in waves:
        np.testing.assert_array_equal(waves[name], seq[name], err_msg=name)
    assert int(states["sequential"].obj_inv[:, :A, program.resource_names.index("heart")].sum()) < heart0, "no hit landed"


def test_sequential_matches_jax():
    """The port's and the JAX engine's sequential phases on the same config,
    fed the same actions, vibes and agent orders."""
    both = build_both(_armor_is_health_cfg(9), [7])
    lockstep(*both, E=8, n_steps=10, seed=3, reference_rng=False, action_mode="sequential", perm=True, vibes=True)
