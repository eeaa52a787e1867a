"""The port's engine primitives (engine/exec.py, engine/handlers.py) against
the JAX engine's, exactly, on random inputs over a real general-config
state: entity gathers and scatters, grid writes, per-type tables, inventory
limits, game values, tag queries with caps and the stat writers.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mettagrid_tpu.engine as jengine
import mettagrid_tpu.engine.exec as jexec
import mettagrid_tpu.engine.handlers as jhandlers
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.engine import exec as texec
from mettagrid_tpu_torch.engine import handlers as thandlers
from mettagrid_tpu_torch.engine.interop import state_from_numpy
from mettagrid_tpu_torch.engine.ir import CompiledQuery, CompiledValue
from tests.test_torch_general import A, E, _build, _cfgs

_CACHE = {}


def _case():
    """(JAX program, port program, JAX state, port state) of the armed
    general config after 6 random steps."""
    if not _CACHE:
        jcfg, tcfg = _cfgs("general", armed=True)
        jp, ji = _build(jengine, jcfg, (3,))
        tp, _ = _build(tengine, tcfg, (3,))
        state, _ = jengine.make_reset(jp, ji, E)(0)
        step = jengine.make_step(jp, ji, auto_reset=False, donate=False)
        rng = np.random.default_rng(1)
        for _ in range(6):
            acts = jnp.asarray(rng.integers(0, 5, (E, A)), dtype=jnp.int32)
            state, _ = step(state, acts, jnp.zeros((E, A), jnp.int32))
        tstate = state_from_numpy({f: np.array(getattr(state, f)) for f in state._fields}, "cpu")
        _CACHE["case"] = (jp, tp, state, tstate)
    return _CACHE["case"]


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got), np.asarray(ref))


def _rand_slots(rng, N, shape):
    return rng.integers(-1, N, shape).astype(np.int32)


def test_gather_scatter_grid_write_match_jax():
    rng = np.random.default_rng(0)
    _, _, js, ts = _case()
    N = ts.obj_inv.shape[1]
    slot = _rand_slots(rng, N, (E, 5))
    _eq(texec.gather(ts.obj_inv, torch.from_numpy(slot)), jexec.gather(js.obj_inv, jnp.asarray(slot)))
    # Distinct slots per env for the masked-on entries, as callers guarantee.
    slot = np.stack([rng.permutation(N)[:5] for _ in range(E)]).astype(np.int32)
    mask = rng.random((E, 5)) < 0.6
    value = rng.integers(0, 9, (E, 5, ts.obj_inv.shape[2])).astype(np.int32)
    _eq(
        texec.scatter(ts.obj_inv, torch.from_numpy(slot), torch.from_numpy(value), torch.from_numpy(mask)),
        jexec.scatter(js.obj_inv, jnp.asarray(slot), jnp.asarray(value), jnp.asarray(mask)),
    )
    H, W = ts.grid.shape[1:]
    cells = np.stack([rng.permutation(H * W)[:6] for _ in range(E)])
    r, c = (cells // W).astype(np.int32), (cells % W).astype(np.int32)
    mask = rng.random((E, 6)) < 0.5
    v = rng.integers(-1, 30, (E, 6)).astype(np.int32)
    _eq(
        texec.grid_write(ts.grid, torch.from_numpy(r), torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(mask)),
        jexec.grid_write(js.grid, jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), jnp.asarray(mask)),
    )
    _eq(texec.true_grid(ts, A), jexec.true_grid(js, A))


def test_inventory_math_matches_jax():
    rng = np.random.default_rng(1)
    jp, tp, _, _ = _case()
    nt, R = np.asarray(jp.type_limit_group).shape
    B = (E, 7)
    tid = rng.integers(-1, nt, B).astype(np.int32)
    inv = rng.integers(0, 300, B + (R,)).astype(np.int32)
    delta = rng.integers(-300, 300, B).astype(np.int32)
    mask = rng.random(B) < 0.7
    table = rng.integers(0, 5, (nt, 3)).astype(np.int32)
    _eq(texec.type_select(tp, torch.from_numpy(tid), table), jexec.type_select(jp, jnp.asarray(tid), table))
    for rid in range(R):
        got = texec.inv_update(tp, *map(torch.from_numpy, (tid, inv)), rid, *map(torch.from_numpy, (delta, mask)))
        ref = jexec.inv_update(jp, *map(jnp.asarray, (tid, inv)), rid, *map(jnp.asarray, (delta, mask)))
        for g, r in zip(got, ref):
            _eq(g, r)
    _eq(
        texec.inv_enforce_limits(tp, *map(torch.from_numpy, (tid, inv, mask))),
        jexec.inv_enforce_limits(jp, *map(jnp.asarray, (tid, inv, mask))),
    )


def _values(jp):
    heart = list(jp.resource_names).index("heart")
    inv = CompiledValue(kind="inventory", rid=heart)
    stat = CompiledValue(kind="stat", stat_id=jp.stat_action_failed)
    gstat = CompiledValue(kind="stat", stat_id=jp.stat_tokens_written, stat_is_game=True, delta=True)
    return [
        CompiledValue(kind="const", value=2.5),
        inv,
        stat,
        gstat,
        CompiledValue(kind="sum", children=(inv, stat), weights=(2.0, -1.0), clamp_min=0.0),
        CompiledValue(kind="ratio", children=(inv, stat)),
        CompiledValue(kind="max", children=(inv, stat)),
        CompiledValue(kind="min"),
    ]


@pytest.mark.parametrize("i", range(8))
def test_eval_value_matches_jax(i):
    import mettagrid_tpu.engine.ir as jir

    rng = np.random.default_rng(i)
    jp, tp, js, ts = _case()
    cv = _values(jp)[i]

    def to_jax(v):
        return jir.CompiledValue(**{f.name: (tuple(to_jax(c) for c in v.children) if f.name == "children" else getattr(v, f.name))
                                    for f in dataclasses.fields(v)})

    slots = _rand_slots(rng, ts.obj_inv.shape[1], (E, 6))
    _eq(texec.eval_value(tp, ts, cv, torch.from_numpy(slots)), jexec.eval_value(jp, js, to_jax(cv), jnp.asarray(slots)))


@pytest.mark.parametrize("max_items", [0, 3])
def test_tag_query_matches_jax(max_items):
    import mettagrid_tpu.engine.ir as jir

    jp, tp, js, ts = _case()
    wall = jp.tag_names.index("type:wall")
    got = texec.eval_query_mask(tp, ts, CompiledQuery(kind="tag", tag_id=wall, max_items=max_items))
    ref = jexec.eval_query_mask(jp, js, jir.CompiledQuery(kind="tag", tag_id=wall, max_items=max_items))
    _eq(got, ref)
    assert int(got.sum()) > 0


@pytest.mark.parametrize("max_items", [1, 3])
def test_random_order_query_keeps_smallest_ranks(max_items):
    """Outside the reference-RNG step an order_by=random query keeps, per
    env, each candidate with fewer than max_items candidates of strictly
    smaller rank, among uniform ranks drawn once per query and step from the
    step's generator (exec.RankDraws): the reference's rule
    (exec.py:779-783). A second evaluation in the step reuses the ranks; the
    next step draws anew."""
    _, tp, _, ts = _case()
    wall = tp.tag_names.index("type:wall")
    q = CompiledQuery(kind="tag", tag_id=wall, max_items=max_items, order_random=True, rng_salt=1)
    full = texec.eval_query_mask(tp, ts, CompiledQuery(kind="tag", tag_id=wall)).numpy()
    draws = texec.RankDraws(torch.Generator().manual_seed(5))
    draws.start_step()
    got = texec.eval_query_mask(tp, ts, q, mtd=draws).numpy()
    ranks = torch.rand(full.shape, generator=torch.Generator().manual_seed(5)).numpy()
    ranks = np.where(full, ranks, np.inf)
    before = (ranks[:, None, :] < ranks[:, :, None]).sum(axis=2)
    want = full & (before < max_items)
    np.testing.assert_array_equal(got, want)
    assert (got.sum(axis=1) == np.minimum(full.sum(axis=1), max_items)).all()
    np.testing.assert_array_equal(texec.eval_query_mask(tp, ts, q, mtd=draws).numpy(), got)
    draws.start_step()
    assert not np.array_equal(texec.eval_query_mask(tp, ts, q, mtd=draws).numpy(), got)


def test_random_order_query_keeps_tied_ranks():
    """Candidates whose ranks tie all survive when fewer than max_items
    candidates rank strictly below them, as the reference counts them
    (exec.py:782-783): fed ranks with every candidate of env 0 tied, and in
    env 1 one smallest rank followed by a tie of two, keep all of env 0 and
    all three of env 1 under max_items 2; a distinct position per candidate
    would keep two."""
    _, tp, _, ts = _case()
    wall = tp.tag_names.index("type:wall")
    q = CompiledQuery(kind="tag", tag_id=wall, max_items=2, order_random=True, rng_salt=4)
    full = texec.eval_query_mask(tp, ts, CompiledQuery(kind="tag", tag_id=wall)).numpy()
    assert (full[:2].sum(axis=1) >= 3).all()
    ranks = np.full(full.shape, 0.9, np.float32)
    ranks[0] = 0.5
    c1 = np.flatnonzero(full[1])
    ranks[1, c1[:3]] = [0.25, 0.5, 0.5]
    draws = texec.RankDraws(torch.Generator().manual_seed(0))
    draws.start_step({4: torch.from_numpy(ranks)})
    got = texec.eval_query_mask(tp, ts, q, mtd=draws).numpy()
    np.testing.assert_array_equal(got[0], full[0])
    want1 = np.zeros_like(full[1])
    want1[c1[:3]] = True
    np.testing.assert_array_equal(got[1], want1)


def test_stat_writers_match_jax():
    rng = np.random.default_rng(3)
    jp, tp, js, ts = _case()
    slot = np.stack([rng.permutation(np.arange(-1, A + 2))[:4] for _ in range(E)]).astype(np.int32)
    mask = rng.random((E, 4)) < 0.7
    value = rng.integers(0, 9, (E, 4)).astype(np.float32)
    sid = jp.stat_action_failed
    for mode in ("set", "add"):
        got = thandlers.set_agent_stat(ts, torch.from_numpy(slot), sid, torch.from_numpy(value), torch.from_numpy(mask), mode=mode)
        ref = jhandlers.set_agent_stat(js, jnp.asarray(slot), sid, jnp.asarray(value), jnp.asarray(mask), mode=mode)
        _eq(got.agent_stats, ref.agent_stats)
        _eq(got.agent_stats_touched, ref.agent_stats_touched)
    got = thandlers.incr_agent_stat(ts, torch.from_numpy(slot), sid, torch.from_numpy(mask))
    ref = jhandlers.incr_agent_stat(js, jnp.asarray(slot), sid, jnp.asarray(mask))
    _eq(got.agent_stats, ref.agent_stats)
    env_mask = rng.random(E) < 0.5
    env_val = rng.integers(0, 9, E).astype(np.float32)
    for mode in ("set", "add"):
        got = thandlers.set_game_stat(ts, torch.from_numpy(env_mask), jp.stat_tokens_free, torch.from_numpy(env_val), mode=mode)
        ref = jhandlers.set_game_stat(js, jnp.asarray(env_mask), jp.stat_tokens_free, jnp.asarray(env_val), mode=mode)
        _eq(got.game_stats, ref.game_stats)
        _eq(got.game_stats_touched, ref.game_stats_touched)


@pytest.mark.parametrize("mode", ["gather", "actor_prefix", "dense"])
def test_entity_inv_update_matches_jax(mode):
    """The inventory update and its auto-stat emission, for each slot
    addressing mode; the port's batched emission equals its direct one."""
    rng = np.random.default_rng(4)
    jp, tp, js, ts = _case()
    N = ts.obj_inv.shape[1]
    if mode == "gather":  # agents and objects, distinct per env
        slot = np.stack([rng.permutation(N)[:6] for _ in range(E)]).astype(np.int32)
    else:
        slot = np.broadcast_to(np.arange(A if mode == "actor_prefix" else N, dtype=np.int32), (E, A if mode == "actor_prefix" else N)).copy()
    mask = rng.random(slot.shape) < 0.7
    delta = rng.integers(-6, 6, slot.shape).astype(np.int32)
    kw = dict(dense_identity=mode == "dense", actor_prefix=mode == "actor_prefix")
    heart = list(jp.resource_names).index("heart")
    ref_state, ref_actual = jhandlers.entity_inv_update(jp, js, jnp.asarray(slot), heart, jnp.asarray(delta), jnp.asarray(mask), **kw)
    targs = (torch.from_numpy(slot), heart, torch.from_numpy(delta), torch.from_numpy(mask))
    got_state, got_actual = thandlers.entity_inv_update(tp, ts, *targs, **kw)
    _eq(got_actual, ref_actual)
    _eq(got_state.obj_inv, ref_state.obj_inv)
    _eq(got_state.auto_stats, ref_state.auto_stats)
    assert not np.array_equal(np.asarray(ref_state.auto_stats), np.asarray(js.auto_stats))
    batch = thandlers.InvStatBatch()
    batched, _ = thandlers.entity_inv_update(tp, ts, *targs, **kw, batch=batch)
    _eq(batched.auto_stats, ts.auto_stats)
    _eq(thandlers.flush_inv_stat_batch(tp, batched, batch).auto_stats, ref_state.auto_stats)
