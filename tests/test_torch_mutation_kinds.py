"""The mutation kinds that write no position, and swap, against the JAX
engine, exactly.

One case per kind (and per filter kind in tests/test_torch_filter_kinds.py,
which shares these helpers): a small arena (4 agents that start with
lasers, armor, hearts and ore; chests that hold ore) whose first move
handler carries the kind, and whose event or agent on_tick handler carries
it too, so that each kind runs in a wave batch (an [E, A] context) or the
sequential phase (an [E] context), and densely over every object (an
event's [E, N] context) or over the agents (on_tick). The JAX engine steps
with its sequential action phase, the port with its own choice of phase
("auto": waves where fast_mode_ok holds, which must agree with the
reference's gate); both take the same actions, vibe actions and agent
orders, drawn with numpy, from the port's reset state (whose equality with
the JAX engine's reset tests/test_torch_step.py holds), and every output
and every state field but ``rng`` must be equal after every step (the grid
with its agent layer rebuilt where the port's waves keep it lazily).
Tolerance: exact (integer inventories, float stats that are sums of small
integers).

Also held here: the port's sequential phase against its waves on the cases
the waves serve; the repair of ``remove_source_when_empty`` under the lazy
grid, where the port's waves must equal the JAX engine's sequential phase
and the port's own while the JAX engine's waves leave an emptied chest's
cell stale, and the auto-reset merge must restore the cleared cell; and a
closure query in a move handler's filter and a filtered query in a value
observation, in lockstep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mettagrid_tpu.engine as jengine
import mettagrid_tpu.engine.actions_fast as jfast
import mettagrid_tpu.engine.state as jstate_mod
from mettagrid_tpu.engine.exec import true_grid as jtrue_grid
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.builder import make_arena
from mettagrid_tpu_torch.config.event_config import EventConfig, periodic
from mettagrid_tpu_torch.config.game_config import GridObjectConfig, InventoryConfig
from mettagrid_tpu_torch.config.game_value import ConstValue, InventoryValue, QueryInventoryValue, StatValue
from mettagrid_tpu_torch.config.handler_config import (
    AddTagMutation,
    AttackMutation,
    ClearInventoryMutation,
    EntityTarget,
    Handler,
    HandlerTarget,
    MaxDistanceFilter,
    NotFilter,
    OrFilter,
    PeriodicFilter,
    QueryInventoryMutation,
    QueryResourceFilter,
    RemoveTagMutation,
    RemoveTagsWithPrefixMutation,
    ResourceDeltaMutation,
    ResourceFilter,
    ResourceTransferMutation,
    SetGameValueMutation,
    StatsEntity,
    StatsMutation,
    StatsTarget,
    SwapMutation,
    TagFilter,
)
from mettagrid_tpu_torch.config.query import ClosureQuery, Query
from mettagrid_tpu_torch.config.tag import typeTag
from mettagrid_tpu_torch.engine.actions_fast import batch_gridless, fast_mode_ok
from mettagrid_tpu_torch.engine.exec import true_grid
from mettagrid_tpu_torch.engine.interop import state_to_numpy
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from tests.test_torch_reference_rng import build_both
from tests.test_torch_step import _assert_outputs_equal, _assert_states_equal, _jax_state_numpy

A = 4
E = 4
STEPS = 8


def _has(target, **resources):
    return ResourceFilter(target=target, resources=resources)


def _delta(target, **deltas):
    return ResourceDeltaMutation(target=target, deltas=deltas)


def _chests(n=4):
    return Query(source=typeTag("chest"), max_items=n).model_dump()


def _base_cfg():
    """The arena on 7x7 maps (border 1) with 4 walls and 4 chests, each
    chest holding 2 ore_red and tagged box and team:blue; agents tagged
    team:red start with laser 2, armor 1, heart 6 and ore_red 3."""
    cfg = make_arena(A, combat=False, map_builder=RandomMapBuilder.Config(
        agents=A, width=7, height=7, border_width=1, objects={"wall": 4, "chest": 4}))
    cfg.game.objects["chest"] = GridObjectConfig(
        name="chest", map_name="chest", tags=["box", "team:blue"],
        inventory=InventoryConfig(initial={"ore_red": 2}))
    cfg.game.agent.inventory.initial = {"laser": 2, "armor": 1, "heart": 6, "ore_red": 3}
    cfg.game.agent.tags = ["team:red", "marked"]
    return cfg


def _event(name, target, mutations, filters=(), start=2, period=3):
    return EventConfig(name=name, target_query=typeTag(target), timesteps=periodic(start=start, period=period, end=60),
                       filters=list(filters), mutations=list(mutations))


def _move(name, mutations, filters=()):
    return Handler(name=name, filters=list(filters), mutations=list(mutations))


def _case(kind):
    """The config of one case: its move handler (first in the chain) and its
    event or agent on_tick handler."""
    cfg = _base_cfg()
    g = cfg.game
    A_, T_ = EntityTarget.ACTOR, EntityTarget.TARGET
    HA, HT = HandlerTarget.ACTOR, HandlerTarget.TARGET
    move, event, tick = None, None, None
    if kind == "swap":
        move = _move("swap", [SwapMutation()], [_has(HA, armor=1)])
        tick = _move("self_swap", [SwapMutation()], [PeriodicFilter(period=2)])
    elif kind == "resource_transfer":
        move = _move("loot", [ResourceTransferMutation(from_target=T_, to_target=A_, resources={"ore_red": 1},
                                                       remove_source_when_empty=True),
                              ResourceTransferMutation(from_target=A_, to_target=T_, resources={"heart": -1})],
                     [_has(HA, laser=1)])
        event = _event("pour", "chest", [ResourceTransferMutation(from_target=T_, to_target=A_,
                                                                  resources={"ore_red": -1},
                                                                  remove_source_when_empty=True)])
    elif kind == "clear_inventory":
        move = _move("wipe", [ClearInventoryMutation(target=T_, limit_name="heart")], [_has(HA, ore_red=3)])
        event = _event("wipe_all", "agent", [ClearInventoryMutation(target=T_, limit_name="heart")], start=5, period=4)
    elif kind == "attack":
        hit = AttackMutation(weapon_resources={"laser": 2}, armor_resources={"armor": 1},
                             defense_resources={"ore_red": 1}, vibe_bonus={"default": 1},
                             on_success=[_delta(T_, heart=-2), _delta(A_, laser=-1)])
        move = _move("attack", [hit], [_has(HA, laser=1)])
        event = _event("self_attack", "agent", [hit], start=3)
    elif kind == "add_tag":
        move = _move("tag", [AddTagMutation(target=T_, tag="box")])
        tick = _move("self_tag", [AddTagMutation(target=A_, tag="team:blue")], [PeriodicFilter(period=3)])
    elif kind == "remove_tag":
        move = _move("untag", [RemoveTagMutation(target=T_, tag="box")], [_has(HA, laser=1)])
        event = _event("unmark", "agent", [RemoveTagMutation(target=T_, tag="marked")])
    elif kind == "remove_tags_with_prefix":
        move = _move("unteam", [RemoveTagsWithPrefixMutation(target=T_, prefix="team")])
        event = _event("unteam_all", "chest", [RemoveTagsWithPrefixMutation(target=T_, prefix="team")], start=4)
    elif kind == "stats":
        move = _move("count", [StatsMutation(stat="target.heart", target=StatsTarget.AGENT, entity=StatsEntity.ACTOR,
                                             source=InventoryValue(item="heart"))])
        tick = _move("tally", [StatsMutation(stat="own.ore", target=StatsTarget.AGENT, entity=StatsEntity.TARGET,
                                             source=InventoryValue(item="ore_red"))])
        g.on_tick = _move("game_tally", [StatsMutation(stat="chest.ore", target=StatsTarget.GAME,
                                                       source=QueryInventoryValue(query=_chests(), item="ore_red"))])
    elif kind == "set_game_value":
        move = _move("grant", [SetGameValueMutation(value=InventoryValue(item="ore_red"), delta=1, target=A_),
                               SetGameValueMutation(value=StatValue(name="bumps"), source=ConstValue(value=2),
                                                    target=T_)])
        tick = _move("drain", [SetGameValueMutation(value=InventoryValue(item="heart"), delta=-1, target=A_)],
                     [PeriodicFilter(period=3)])
        g.on_tick = _move("game_bump", [SetGameValueMutation(value=StatValue(name="game.ticks"), delta=1)])
    elif kind == "query_inventory":
        move = _move("raid", [QueryInventoryMutation(query=_chests(2), deltas={"ore_red": -1}, source=A_,
                                                     transfer_stats={"ore_red": "raided"})], [_has(HA, laser=1)])
        event = _event("refill", "chest", [QueryInventoryMutation(query=_chests(), deltas={"ore_red": 1})], start=3)
    elif kind == "max_distance":
        # Range 2: the line scan and the Chebyshev waves (r_int = 4).
        move = _move("reach", [_delta(T_, heart=-1)], [MaxDistanceFilter(radius=2), _has(HA, laser=1)])
        event = _event("near_box", "agent", [_delta(T_, ore_red=1)],
                       [MaxDistanceFilter(target=HT, query=_chests(), radius=2)])
    elif kind == "not":
        move = _move("spare", [_delta(T_, heart=-1)], [NotFilter(inner=_has(HT, armor=2))])
        event = _event("unboxed", "agent", [_delta(T_, ore_red=1)], [NotFilter(inner=TagFilter(target=HT, tag="box"))])
    elif kind == "or":
        move = _move("either", [_delta(A_, ore_red=1)], [OrFilter(inner=[_has(HT, ore_red=3), _has(HA, heart=7)])])
        event = _event("either_all", "chest", [_delta(T_, ore_red=1)],
                       [OrFilter(inner=[_has(HT, ore_red=3), TagFilter(target=HT, tag="marked")])])
    elif kind == "periodic":
        move = _move("beat", [_delta(T_, heart=-1)], [PeriodicFilter(period=2, start_on=3)])
        tick = _move("pulse", [_delta(A_, laser=1)], [PeriodicFilter(period=3)])
    elif kind == "query_resource":
        rich = QueryResourceFilter(query=_chests(), resources={"ore_red": 7})
        move = _move("rich", [_delta(A_, heart=1)], [rich])
        event = _event("rich_all", "agent", [_delta(T_, laser=1)], [rich])
    else:
        raise AssertionError(kind)
    g.actions.move.handlers = [move]
    if event is not None:
        g.events = {event.name: event}
    if tick is not None:
        g.agent.on_tick = tick
    return cfg


MUTATIONS = ["swap", "resource_transfer", "clear_inventory", "attack", "add_tag", "remove_tag",
             "remove_tags_with_prefix", "stats", "set_game_value", "query_inventory"]
FILTERS = ["max_distance", "not", "or", "periodic", "query_resource"]


def _assert_equal(jstate, jout, tstate, tout, lazy, where):
    _assert_outputs_equal(jout, tout, where=where)
    ref = _jax_state_numpy(jstate)
    if lazy:
        tstate = tstate._replace(grid=true_grid(tstate, A))
    _assert_states_equal(ref, tstate, where=where)


def _draws(rng, n_actions):
    """One step's actions (noop and the four moves), vibe actions (any index,
    out-of-range ones included) and agent orders."""
    acts = rng.integers(0, 5, (E, A)).astype(np.int32)
    vib = rng.integers(-1, n_actions + 1, (E, A)).astype(np.int32)
    perm = np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32)
    return acts, vib, perm


def _port_run(cfg, mode="auto", n_steps=STEPS, seed=0, auto_reset=False):
    """The port alone on _lockstep's maps and draws; returns its last state."""
    (_, _), (tp, ti) = build_both(cfg, [7])
    step = tengine.make_step(tp, ti, auto_reset=auto_reset, device="cpu", action_mode=mode, external_perm=True)
    state, out = tengine.make_reset(tp, ti, E, device="cpu")(0)
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        acts, vib, p = (torch.from_numpy(x) for x in _draws(rng, len(tp.action_names)))
        state, out = step(state, acts, vib, p, out.observations)
    return state


def assert_inits_equal(jax_init, port_init):
    """The two engines' EnvInit of one config and maps, field by field (the
    JAX reset is skipped, so its inputs are compared instead)."""
    for f in port_init.__dataclass_fields__:
        got, ref = getattr(port_init, f), getattr(jax_init, f)
        assert got.dtype == ref.dtype, f
        np.testing.assert_array_equal(got, ref, err_msg=f)


def jax_state_of(port_state):
    """The JAX engine's EnvState holding the port's state (the port's reset
    equals the JAX engine's, tests/test_torch_step.py), with per-env PRNG
    keys that steps fed their agent orders never read. Saves the JAX
    reset's compile."""
    arrays = state_to_numpy(port_state)
    arrays["rng"] = jax.vmap(jax.random.PRNGKey)(jnp.arange(arrays["rng"].shape[0]))
    arrays["mt"] = np.zeros(arrays["mt"].shape, np.uint32)
    return jstate_mod.EnvState(**{f: jnp.asarray(v) for f, v in arrays.items()})


def _lockstep(cfg, jax_mode="sequential", port_mode="auto", n_steps=STEPS, seed=0):
    """Steps the JAX engine (``jax_mode``) and the port (``port_mode``) from
    the port's reset on its map of seed 7, comparing after every step; the
    port's grid is compared with its agent layer rebuilt where its waves run
    gridless. Returns (JAX state, port state, port step)."""
    (jp, ji), (tp, ti) = build_both(cfg, [7])
    assert_inits_equal(ji, ti)
    assert fast_mode_ok(tp) == jfast.fast_mode_ok(jp)
    jstep = jengine.make_step(jp, ji, auto_reset=False, donate=False, action_mode=jax_mode, external_perm=True)
    tstep = tengine.make_step(tp, ti, auto_reset=False, device="cpu", action_mode=port_mode, external_perm=True)
    lazy = tstep.lazy_grid
    tstate, tout = tengine.make_reset(tp, ti, E, device="cpu")(0)
    jstate, jbuf = jax_state_of(tstate), jnp.asarray(tout.observations.numpy())
    rng = np.random.default_rng(seed)
    for i in range(n_steps):
        acts, vib, p = _draws(rng, len(tp.action_names))
        jstate, jout = jstep(jstate, jnp.asarray(acts), jnp.asarray(vib), jnp.asarray(p), jbuf)
        jbuf = jout.observations
        tstate, tout = tstep(tstate, torch.from_numpy(acts), torch.from_numpy(vib), torch.from_numpy(p),
                             tout.observations)
        _assert_equal(jstate, jout, tstate, tout, lazy, f"step {i}: ")
    return jstate, tstate, tstep


@pytest.mark.parametrize("kind", MUTATIONS)
def test_kind_matches_jax(kind):
    """The port's phase (waves where its gate admits the handler) against the
    JAX engine's sequential phase; the kind's handlers must have applied."""
    check_kind(kind)


def check_kind(kind):
    """test_kind_matches_jax's body, shared with the filter kinds' file."""
    cfg = _case(kind)
    _, tstate, _ = _lockstep(cfg)
    tp = tengine.compile_program(cfg)
    if kind in MUTATIONS:
        assert kind in {m.kind for mh in tp.move_handlers for m in mh.handler.mutations}
    else:
        assert kind in {f.kind for mh in tp.move_handlers for f in mh.handler.filters}
    # The port's run without the case's handlers ends elsewhere: they applied.
    g = cfg.game
    g.actions.move.handlers, g.events, g.agent.on_tick, g.on_tick = [], {}, None, None
    bare = _port_run(cfg)
    assert any(not torch.equal(getattr(tstate, f), getattr(bare, f)) for f in tstate._fields), "no handler applied"


@pytest.mark.parametrize("kind", ["swap", "attack", "clear_inventory"])
def test_sequential_phase_matches_waves(kind):
    """The port's sequential phase (an [E] context per agent rank) equals its
    waves on the cases the waves serve, so it equals the JAX engine's
    sequential phase too (test_kind_matches_jax, same draws)."""
    cfg = _case(kind)
    waves, seq = _port_run(cfg), _port_run(cfg, mode="sequential")
    for f in waves._fields:
        a = true_grid(waves, A) if f == "grid" else getattr(waves, f)
        np.testing.assert_array_equal(a.numpy(), getattr(seq, f).numpy(), err_msg=f)


def _gridless_transfer_cfg():
    """Agents that bump a chest take one ore_red from it, and the chest goes
    once it is empty: range 1 and no swap, so the port's and the JAX
    engine's waves run gridless."""
    cfg = _base_cfg()
    cfg.game.actions.move.handlers = [
        _move("loot", [ResourceTransferMutation(from_target=EntityTarget.TARGET, to_target=EntityTarget.ACTOR,
                                                resources={"ore_red": 1}, remove_source_when_empty=True)],
              [TagFilter(target=HandlerTarget.TARGET, tag="box")]),
    ]
    return cfg


def test_remove_source_when_empty_under_lazy_grid():
    """The port's gridless waves clear an emptied chest's cell: they equal
    the JAX engine's sequential phase and the port's sequential phase on
    every field, the grid with its agent layer rebuilt. The JAX engine's
    waves keep the chest's slot in that cell (the reference fault this
    repairs), shown and not asserted equal."""
    cfg = _gridless_transfer_cfg()
    (jp, ji), (tp, ti) = build_both(cfg, [7])
    assert batch_gridless(tp)
    jstate, tstate, tstep = _lockstep(cfg, n_steps=12)
    assert tstep.action_phase_kind == "waves"
    seq_state = _port_run(cfg, mode="sequential", n_steps=12)
    for f in tstate._fields:
        a, b = getattr(tstate, f), getattr(seq_state, f)
        if f == "grid":
            a = true_grid(tstate, A)
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    chest = tp.type_names.index("chest")
    gone = (tstate.obj_type == chest) & ~tstate.obj_alive
    assert int(gone.sum()) > 0, "no chest was emptied"
    # The JAX engine's waves on the same run: an emptied chest's cell still
    # names the chest.
    jstep = jengine.make_step(jp, ji, auto_reset=False, donate=False, action_mode="auto", external_perm=True)
    jfast_state = jax_state_of(tengine.make_reset(tp, ti, E, device="cpu")(0)[0])
    rng = np.random.default_rng(0)
    for _ in range(12):
        acts, vib, p = _draws(rng, len(tp.action_names))
        jfast_state, _ = jstep(jfast_state, jnp.asarray(acts), jnp.asarray(vib), jnp.asarray(p))
    np.testing.assert_array_equal(np.asarray(jfast_state.obj_alive), tstate.obj_alive.numpy())
    stale = np.asarray(jtrue_grid(jfast_state, A)) != np.asarray(jstate.grid)
    assert stale.any(), "the reference's waves cleared every emptied chest's cell"
    e, r, c = np.argwhere(stale)[0]
    slot = int(np.asarray(jfast_state.grid)[e, r, c])
    assert slot >= A and not bool(np.asarray(jfast_state.obj_alive)[e, slot])
    # With auto-reset on this one-map pool the merge must restore the
    # cleared cell: the waves write it, so the grid is merged.
    cfg.game.max_steps = 6
    waves = _port_run(cfg, n_steps=13, auto_reset=True)
    seq = _port_run(cfg, mode="sequential", n_steps=13, auto_reset=True)
    np.testing.assert_array_equal(true_grid(waves, A).numpy(), seq.grid.numpy())
    np.testing.assert_array_equal(waves.obj_alive.numpy(), seq.obj_alive.numpy())


@pytest.mark.parametrize("where", ["move", "value_obs"])
def test_unported_query_kinds_refused_when_built(where):
    """A closure query reached from a move handler's query_resource filter
    (the sequential phase), or a filtered query (a query over a query)
    reached from a value observation (the waves), once refused when the step
    was made: both now step in lockstep with the JAX engine's sequential
    phase, and the handler pays."""
    cfg = _base_cfg()
    if where == "move":
        q = ClosureQuery(source=typeTag("chest"), candidates=typeTag("chest")).model_dump()
        cfg.game.actions.move.handlers = [
            _move("closure", [_delta(EntityTarget.ACTOR, heart=1)],
                  [QueryResourceFilter(query=q, resources={"ore_red": 1})])]
    else:
        q = Query(source=Query(source=typeTag("chest")).model_dump()).model_dump()
        cfg.game.obs.global_obs.obs = {"chest_ore": QueryInventoryValue(query=q, item="ore_red")}
    _, tstate, tstep = _lockstep(cfg)
    assert tstep.action_phase_kind == ("sequential" if where == "move" else "waves")
    if where == "move":
        assert int(tstate.obj_inv[:, :A, tengine.compile_program(cfg).resource_names.index("heart")].sum()) > 6 * A * E
