"""Engine primitives: entity gathers and scatters, grid reads and writes,
inventory math, game values, filters and queries.

Counterpart of the reference's engine/exec.py: every filter kind and every
query kind (tag, filtered, closure, raycast). The reference formulates
gathers as one-hot matmuls, a workaround for XLA on the TPU (its
``_use_onehot``); here they are direct gathers and ``scatter_`` calls.
Every function works out of place.

Batch convention: context fields have shape B = (E, ...): (E, A) in move
waves and territory contexts, (E, N) in event and query contexts, (E, N, A)
in AOE contexts, (E, N, N) in closure edge contexts. State arrays are
[E, N, ...];
slot -1 means "no entity" (gathers clip it to slot 0; callers mask).

Draws: order_by=random queries take their randomness from a draw source
``mtd`` threaded through filters, values and queries: an MtThread (the
reference-RNG step: the per-env MT19937 twin, bit-exact) or a RankDraws
(otherwise: ranks from the step's torch.Generator).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from mettagrid_tpu_torch.engine.ir import CompiledFilter, CompiledQuery, CompiledValue
from mettagrid_tpu_torch.engine.mt19937 import shuffle_perm
from mettagrid_tpu_torch.engine.program import AMOUNT_STAT_BASE, AUTO_STAT_BASE, DIR_DC, DIR_DR
from mettagrid_tpu_torch.profiling import trace

_I32 = torch.int32


class Ctx(NamedTuple):
    """Execution context (reference: handler/handler_context.hpp:38-112)."""

    actor: torch.Tensor  # int32[B] slot (-1 = none)
    target: torch.Tensor  # int32[B] slot (-1 = none)
    target_r: torch.Tensor  # int32[B]
    target_c: torch.Tensor  # int32[B]
    distance: torch.Tensor  # int32[B]
    timestep: torch.Tensor  # int32[E] (broadcasts over the rest of B)
    actor_tags: Optional[torch.Tensor] = None  # bool[B, n_tags] territory proxy actor
    # actor and target are the identity over the full object axis
    # (slot[e, i] == i, B == [E, N]): event contexts read whole arrays.
    dense_identity: bool = False
    # actor is the agent-prefix identity (actor[e, i] == i, B == [E, A]):
    # move-wave contexts read actor rows as [:, :A] slices.
    actor_prefix: bool = False
    # actor[e, i, j] == i and target[e, i, j] == j (B == [E, N, N]): closure
    # edge contexts read actor and target rows as broadcast views.
    pair_identity: bool = False
    # The caller maintains no agent layer in the grid (gridless wave
    # batches, actions_fast.batch_gridless): agent-layer grid writes are
    # skipped; true_grid rebuilds the layer.
    lazy_grid: bool = False
    # Inventory-stat batch of the enclosing wave batch
    # (handlers.InvStatBatch), or None: emissions apply at once.
    inv_batch: object = None

    def bcast_timestep(self) -> torch.Tensor:
        t = self.timestep
        while t.dim() < self.actor.dim():
            t = t[..., None]
        return t.expand(self.actor.shape)


class MtThread:
    """Carries the per-env MT19937 twin (engine/mt19937.py) through nested
    filter, value and query evaluations of the reference-RNG step
    (reference exec.py:57-100).

    The reference draws from HandlerContext::rng in QuerySystem::apply_limits
    (core/query_system.cpp:78-79: a std::shuffle whenever order_by=random,
    before the max_items resize). Every order_by=random query evaluated with
    an MtThread draws that shuffle from ``mt``, gated by ``active``, the
    per-env mask of evaluations live at this point of the reference's
    sequential walk (C++ filters short-circuit, FirstMatch stops at the first
    applied handler, a failed mutation stops later ones). Callers narrow
    ``active`` around sub-evaluations with ``narrowed`` and write ``mt``
    back into the state after the handler application."""

    __slots__ = ("mt", "active")

    def __init__(self, mt: torch.Tensor, active: torch.Tensor):
        self.mt = mt
        self.active = active

    @contextlib.contextmanager
    def narrowed(self, gate):
        """Within the block, ``active`` is ANDed with gate (bool[E])."""
        saved = self.active
        if gate is not None:
            self.active = saved & gate
        try:
            yield self
        finally:
            self.active = saved


class RankDraws:
    """The draw source of order_by=random queries outside the reference-RNG
    step: uniform ranks f32[E, N] drawn from ``generator`` once per query
    per step, keyed by the query's ``rng_salt``, and reused by every
    evaluation of that query within the step, as the reference draws them
    from its step key folded with the salt (exec.py:770-783). Both deviate
    from the C++ engine's MT19937 stream, which only the reference-RNG step
    reproduces. ``start_step`` clears the ranks; its ``fed`` ranks
    ({rng_salt: f32[E, N]}, a parity hook) take the place of the draws."""

    __slots__ = ("generator", "_ranks", "_fed")

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self._ranks = {}
        self._fed = None

    def start_step(self, fed=None):
        self._ranks = {}
        self._fed = fed

    def ranks(self, salt: int, E: int, N: int, device) -> torch.Tensor:
        r = self._ranks.get(salt)
        if r is None:
            if self._fed is not None:
                if salt not in self._fed:
                    raise KeyError(f"query_ranks has no ranks for the order_by=random query of rng_salt {salt}")
                r = self._fed[salt].to(device=device, dtype=torch.float32)
            else:
                r = torch.rand((E, N), generator=self.generator, device=device)
            if tuple(r.shape) != (E, N):
                raise ValueError(f"ranks of rng_salt {salt} have shape {tuple(r.shape)}, expected {(E, N)}")
            self._ranks[salt] = r
        return r

    def narrowed(self, gate):
        return contextlib.nullcontext(self)


def _env_gate(mask: torch.Tensor, reduce: str) -> torch.Tensor:
    """A per-env [E] gate from a batch mask [E, ...]: all or any over the rest."""
    while mask.dim() > 1:
        mask = mask.all(dim=-1) if reduce == "all" else mask.any(dim=-1)
    return mask


def device_table(program, table_np, device) -> torch.Tensor:
    """The copy of a static table of ``program`` on ``device``, uploaded once
    and kept on the program: a host-to-device copy on the step path would
    wait for the device."""
    a = np.ascontiguousarray(table_np)
    key = (a.dtype.str, a.shape, a.tobytes(), str(torch.device(device)))
    cache = program.__dict__.setdefault("_device_tables", {})
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.from_numpy(a.copy()).to(device)
    return t


def gather(arr: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """arr[e, slot[e, ...], ...]: arr [E, N, *rest], slot [E, *B2] -> [E, *B2, *rest]
    (slots clipped into [0, N))."""
    E, N = arr.shape[0], arr.shape[1]
    rest = tuple(arr.shape[2:])
    flat = slot.reshape(E, -1).clamp(0, N - 1).long()  # [E, M]
    a2 = arr.reshape(E, N, -1)
    out = torch.gather(a2, 1, flat[..., None].expand(E, flat.shape[1], a2.shape[2]))
    return out.reshape(tuple(slot.shape) + rest)


def _values_like(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` in ``like``'s dtype on its device; a number is filled in on
    the device, with no copy from host memory (which a CUDA graph capture
    refuses)."""
    if isinstance(value, (int, float, np.number, np.bool_)):
        return torch.full((), value, dtype=like.dtype, device=like.device)
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def scatter(arr: torch.Tensor, slot: torch.Tensor, value, mask: torch.Tensor) -> torch.Tensor:
    """Masked write arr[e, slot] = value, out of place. Masked-off entries
    never write; masked-on slots within an env must be distinct (callers
    guarantee it)."""
    E, N = arr.shape[0], arr.shape[1]
    rest = tuple(arr.shape[2:])
    flat = slot.reshape(E, -1)
    M = flat.shape[1]
    v = _values_like(value, arr).broadcast_to(tuple(slot.shape) + rest)
    v = v.reshape(E, M, -1)
    idx = torch.where(mask.reshape(E, M), flat.clamp(0, N - 1), N).long()  # N: a spare row
    a2 = arr.reshape(E, N, -1)
    out = torch.cat([a2, a2[:, :1]], dim=1)
    out.scatter_(1, idx[..., None].expand(E, M, a2.shape[2]), v)
    return out[:, :N].reshape(arr.shape)


def grid_write(grid: torch.Tensor, r: torch.Tensor, c: torch.Tensor, value, mask: torch.Tensor) -> torch.Tensor:
    """Masked write grid[e, r, c] = value for [E, *B2]-shaped coordinates
    (masked-on coordinates clipped into bounds), out of place."""
    E, H, W = grid.shape
    m = mask.reshape(E, -1)
    rr = torch.where(m, r.reshape(E, -1).clamp(0, H - 1), H)  # row H: a spare row
    cc = c.reshape(E, -1).clamp(0, W - 1)
    v = _values_like(value, grid).broadcast_to(mask.shape).reshape(E, -1)
    out = torch.cat([grid.reshape(E, H * W), grid.new_zeros((E, W))], dim=1)
    out.scatter_(1, (rr * W + cc).long(), v)
    return out[:, : H * W].reshape(E, H, W)


def grid_read(grid: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """grid[e, r, c] for [E, *B2]-shaped coordinates (clipped into bounds)."""
    E, H, W = grid.shape
    rf = r.reshape(E, -1).clamp(0, H - 1)
    cf = c.reshape(E, -1).clamp(0, W - 1)
    idx = (rf * W + cf).long()
    return torch.gather(grid.reshape(E, H * W), 1, idx).reshape(r.shape)


def agent_slot_ok(slot: torch.Tensor, num_agents: int) -> torch.Tensor:
    return (slot >= 0) & (slot < num_agents)


def true_grid(state, num_agents: int) -> torch.Tensor:
    """The grid with its agent layer rebuilt from positions. Under the lazy
    grid (pure-move waves on a static background, or gridless wave batches)
    state.grid's agent entries are stale; this is the canonical
    reconstruction."""
    E = state.grid.shape[0]
    g = torch.where((state.grid >= 0) & (state.grid < num_agents), -1, state.grid)
    slots = torch.arange(num_agents, dtype=_I32, device=g.device)[None, :].expand(E, num_agents)
    return grid_write(g, state.obj_r[:, :num_agents], state.obj_c[:, :num_agents], slots, state.obj_alive[:, :num_agents])


# =====================================================================
# Inventory math (reference: objects/inventory.cpp:38-88, inventory.hpp:16-41)
# =====================================================================


def type_select(program, tid: torch.Tensor, table_np) -> torch.Tensor:
    """Rows of a static per-type table: table_np [nt, *rest] indexed by
    tid [*B] -> int32[*B, *rest]. An out-of-range tid (-1 of a masked-off
    slot) gives an all-zero row, as the reference's one-hot contraction."""
    tbl = device_table(program, np.asarray(table_np).astype(np.int32), tid.device)
    nt = tbl.shape[0]
    rows = tbl[tid.clamp(0, nt - 1).long()]
    ok = ((tid >= 0) & (tid < nt)).reshape(tuple(tid.shape) + (1,) * (tbl.dim() - 1))
    return torch.where(ok, rows, 0)


def _limit_tables(program, rid: int, device):
    """The per-type tables of resource ``rid``'s limit group, on ``device``:
    int32 [nt, 1 + 2R + 2] rows of (in a group, member mask, modifier
    weights, group min, group max), built once per program."""
    cache = program.__dict__.setdefault("_limit_tables", {})
    key = (rid, str(torch.device(device)))
    t = cache.get(key)
    if t is None:
        member_np = np.asarray(program.type_group_member)  # [nt, G, R]
        gmin_np = np.asarray(program.type_group_min)  # [nt, G]
        nt, G = gmin_np.shape
        ts = np.arange(nt)
        gid_np = np.asarray(program.type_limit_group)[:, rid]
        gsel_np = np.clip(gid_np, 0, max(G - 1, 0))
        rows = np.concatenate([
            (gid_np >= 0)[:, None], member_np[ts, gsel_np], np.asarray(program.type_group_modw)[ts, gsel_np],
            gmin_np[ts, gsel_np][:, None], np.asarray(program.type_group_max)[ts, gsel_np][:, None],
        ], axis=1).astype(np.int32)
        t = cache[key] = torch.from_numpy(rows).to(device)
    return t


def inv_update(program, tid, inv, rid: int, delta, mask):
    """Clamped shared-limit inventory update for one static resource id.

    tid: int32[B]; inv: int32[B, R]; delta, mask: [B]. Returns (new_inv,
    actual_delta). The effective limit is clamp(min(max, max(min,
    sum(modifier*qty))), 0, 65535); this item's capacity is the effective
    limit less what the group's other members hold (inventory.cpp:46-57)."""
    tbl = _limit_tables(program, rid, tid.device)
    R = inv.shape[-1]
    # The type's row (an out-of-range tid, -1 of a masked-off slot, reads
    # zeros, as type_select does).
    nt = tbl.shape[0]
    rows = torch.where(((tid >= 0) & (tid < nt))[..., None], tbl[tid.clamp(0, nt - 1).long()], 0)
    has_group = rows[..., 0] > 0
    mem, mw = rows[..., 1 : 1 + R], rows[..., 1 + R : 1 + 2 * R]
    g_min, g_max = rows[..., 1 + 2 * R], rows[..., 2 + 2 * R]

    mod_sum = (inv * mw).sum(dim=-1, dtype=_I32)
    effective = torch.minimum(g_max, torch.maximum(g_min, mod_sum)).clamp(0, 65535)
    used = (inv * mem).sum(dim=-1, dtype=_I32)
    used_by_others = (used - inv[..., rid]).clamp(min=0)
    cap = torch.where(has_group, (effective - used_by_others).clamp(min=0), 65535)

    old = inv[..., rid]
    new = torch.minimum((old + delta).clamp(min=0), cap)
    actual = torch.where(mask, new - old, 0).to(_I32)
    new_inv = inv.clone()
    new_inv[..., rid] = torch.where(mask, new, old).to(inv.dtype)
    return new_inv, actual


def inv_enforce_limits(program, tid, inv, mask):
    """Drop the excess where effective limits shrank (inventory.cpp
    enforce_all_limits): one pass over groups, dropping from resources in
    ascending id order, which is clip(excess - sum_{r' < r} droppable_r', 0,
    droppable_r). Returns the new inventory."""
    member_np = np.asarray(program.type_group_member)  # [nt, G, R]
    modw_np = np.asarray(program.type_group_modw)
    gmin_np = np.asarray(program.type_group_min)  # [nt, G]
    gmax_np = np.asarray(program.type_group_max)
    for g in range(member_np.shape[1]):
        mem = type_select(program, tid, member_np[:, g, :])  # [B, R]
        mw = type_select(program, tid, modw_np[:, g, :])
        g_min = type_select(program, tid, gmin_np[:, g])  # [B]
        g_max = type_select(program, tid, gmax_np[:, g])
        mod_sum = (inv * mw).sum(dim=-1, dtype=_I32)
        effective = torch.minimum(g_max, torch.maximum(g_min, mod_sum)).clamp(0, 65535)
        used = (inv * mem).sum(dim=-1, dtype=_I32)
        excess = torch.where(mask, (used - effective).clamp(min=0), 0)  # [B]
        droppable = inv * mem  # membership is 0/1
        prefix = droppable.cumsum(dim=-1, dtype=_I32) - droppable
        drop = torch.minimum((excess[..., None] - prefix).clamp(min=0), droppable)
        inv = (inv - drop).to(inv.dtype)
    return inv


# =====================================================================
# Game values (reference: core/game_value.cpp:14-120)
# =====================================================================


def eval_value(program, state, cv: CompiledValue, slots: torch.Tensor, ctx: Optional[Ctx] = None, mtd=None) -> torch.Tensor:
    """A game value with the given entity binding. Returns f32 shaped like
    ``slots``. mtd: the draw source of order_by=random queries nested in
    the value (MtThread or RankDraws)."""
    B = tuple(slots.shape)
    dev = slots.device
    A = program.num_agents

    if cv.kind == "const":
        return torch.full(B, cv.value, dtype=torch.float32, device=dev)
    if cv.kind == "inventory":
        val = gather(state.obj_inv, slots)[..., cv.rid].float()
        return torch.where(slots >= 0, val, 0.0)
    if cv.kind == "stat":
        if cv.stat_is_game:
            cur = state.game_stats[:, cv.stat_id]
            if cv.delta:
                cur = cur - state.game_stats_prev[:, cv.stat_id]
            return cur.reshape((B[0],) + (1,) * (len(B) - 1)).expand(B)
        ok = agent_slot_ok(slots, A)
        sl = slots.clamp(0, A - 1)
        sid = cv.stat_id
        if sid >= AMOUNT_STAT_BASE:
            rid = sid - AMOUNT_STAT_BASE
            cur = gather(state.obj_inv, sl)[..., rid]
            if cv.delta:
                cur = cur - gather(state.obj_inv_prev, sl)[..., rid]
            return torch.where(ok, cur.float(), 0.0)
        if sid >= AUTO_STAT_BASE:
            lane = sid - AUTO_STAT_BASE
            cur = gather(state.auto_stats, sl)[..., lane]
            if cv.delta:
                cur = cur - gather(state.auto_stats_prev, sl)[..., lane]
            return torch.where(ok, cur.float(), 0.0)
        cur = gather(state.agent_stats, sl)[..., sid]
        if cv.delta:
            cur = cur - gather(state.agent_stats_prev, sl)[..., sid]
        return torch.where(ok, cur, 0.0)
    if cv.kind == "sum":
        total = torch.zeros(B, dtype=torch.float32, device=dev)
        for i, child in enumerate(cv.children):
            term = eval_value(program, state, child, slots, ctx, mtd)
            if cv.log:
                term = torch.log(term + 1.0)
            w = cv.weights[i] if cv.weights else 1.0
            total = total + w * term
        if cv.clamp_min is not None:
            total = torch.clamp(total, min=cv.clamp_min)
        if cv.clamp_max is not None:
            total = torch.clamp(total, max=cv.clamp_max)
        return total
    if cv.kind == "ratio":
        num = eval_value(program, state, cv.children[0], slots, ctx, mtd)
        den = eval_value(program, state, cv.children[1], slots, ctx, mtd)
        return torch.where(den > 0.0, num / torch.where(den > 0.0, den, 1.0), num)
    if cv.kind in ("max", "min"):
        pick = torch.maximum if cv.kind == "max" else torch.minimum
        out = torch.full(B, -float("inf") if cv.kind == "max" else float("inf"), dtype=torch.float32, device=dev)
        for child in cv.children:
            out = pick(out, eval_value(program, state, child, slots, ctx, mtd))
        return torch.where(torch.isfinite(out), out, 0.0) if not cv.children else out
    if cv.kind in ("query_inventory", "query_count"):
        mask = eval_query_mask(program, state, cv.query, ctx, mtd)  # [E, N]
        if cv.kind == "query_count":
            per_env = mask.sum(dim=-1).float()
        else:
            per_env = torch.where(mask, state.obj_inv[..., cv.rid], 0).sum(dim=-1).float()
        return per_env.reshape((B[0],) + (1,) * (len(B) - 1)).expand(B)
    raise NotImplementedError(f"game value kind {cv.kind!r} is not ported yet")


def eval_value_agents(program, state, cv: CompiledValue, mtd=None) -> torch.Tensor:
    """eval_value with the all-agents identity binding (slot i = agent i).

    Agents occupy slots 0..A-1, so leaf reads are direct [:, :A] slices.
    mtd: the draw source of nested order_by=random queries. Returns
    f32[E, A]."""
    A = program.num_agents

    if cv.kind == "inventory":
        return state.obj_inv[:, :A, cv.rid].float()
    if cv.kind == "stat" and not cv.stat_is_game:
        sid = cv.stat_id
        if sid >= AMOUNT_STAT_BASE:
            rid = sid - AMOUNT_STAT_BASE
            cur = state.obj_inv[:, :A, rid]
            if cv.delta:
                cur = cur - state.obj_inv_prev[:, :A, rid]
            return cur.float()
        if sid >= AUTO_STAT_BASE:
            lane = sid - AUTO_STAT_BASE
            cur = state.auto_stats[:, :, lane]
            if cv.delta:
                cur = cur - state.auto_stats_prev[:, :, lane]
            return cur.float()
        cur = state.agent_stats[:, :, sid]
        if cv.delta:
            cur = cur - state.agent_stats_prev[:, :, sid]
        return cur
    if cv.kind == "sum":
        E = state.obj_type.shape[0]
        total = torch.zeros((E, A), dtype=torch.float32, device=state.obj_type.device)
        for i, child in enumerate(cv.children):
            term = eval_value_agents(program, state, child, mtd)
            if cv.log:
                term = torch.log(term + 1.0)
            w = cv.weights[i] if cv.weights else 1.0
            total = total + w * term
        if cv.clamp_min is not None:
            total = torch.clamp(total, min=cv.clamp_min)
        if cv.clamp_max is not None:
            total = torch.clamp(total, max=cv.clamp_max)
        return total
    if cv.kind == "ratio":
        num = eval_value_agents(program, state, cv.children[0], mtd)
        den = eval_value_agents(program, state, cv.children[1], mtd)
        return torch.where(den > 0.0, num / torch.where(den > 0.0, den, 1.0), num)
    if cv.kind in ("max", "min") and cv.children:
        pick = torch.maximum if cv.kind == "max" else torch.minimum
        out = None
        for child in cv.children:
            term = eval_value_agents(program, state, child, mtd)
            out = term if out is None else pick(out, term)
        return out
    E = state.obj_type.shape[0]
    slots = torch.arange(A, dtype=_I32, device=state.obj_type.device)[None, :].expand(E, A)
    return eval_value(program, state, cv, slots, None, mtd)


# =====================================================================
# Filters (reference: handler/filters/)
# =====================================================================


def eval_filter(program, state, ctx: Ctx, f: CompiledFilter, mtd=None) -> torch.Tensor:
    def eread(arr, slot, is_actor=False):
        if ctx.dense_identity:
            return arr
        if ctx.pair_identity:
            return arr[:, :, None] if is_actor else arr[:, None, :]
        if is_actor and ctx.actor_prefix:
            return arr[:, : slot.shape[1]]
        return gather(arr, slot)

    slot = ctx.actor if f.target_is_actor else ctx.target
    # A territory's proxy actor has no slot, only the winning tag.
    proxy_tags = ctx.actor_tags if f.target_is_actor else None
    if f.kind == "target_loc_empty":
        return ctx.target < 0
    if f.kind == "target_is_usable":
        ttype = eread(state.obj_type, ctx.target)
        usable = type_select(program, ttype, np.asarray(program.type_usable, dtype=np.int32)) > 0
        return (ctx.target >= 0) & usable
    if f.kind == "vibe":
        vibe = eread(state.obj_vibe, slot, f.target_is_actor)
        return (slot >= 0) & (vibe == f.vibe_id)
    if f.kind == "resource":
        inv = eread(state.obj_inv, slot, f.target_is_actor)  # [B, R]
        ok = slot >= 0
        for rid, amount in f.resource_mins:
            ok = ok & (inv[..., rid] >= amount)
        return ok
    if f.kind == "tag":
        if proxy_tags is not None:
            return proxy_tags[..., f.tag_id]
        return (slot >= 0) & eread(state.obj_tags, slot, f.target_is_actor)[..., f.tag_id]
    if f.kind == "tag_prefix":
        pm = device_table(program, f.tag_mask, slot.device)
        if proxy_tags is not None:
            return (proxy_tags & pm).any(dim=-1)
        return (slot >= 0) & (eread(state.obj_tags, slot, f.target_is_actor) & pm).any(dim=-1)
    if f.kind == "shared_tag_prefix":
        if ctx.actor_tags is not None:
            at = ctx.actor_tags
            actor_ok = at.any(dim=-1)
        else:
            at = eread(state.obj_tags, ctx.actor, True)
            actor_ok = ctx.actor >= 0
        tt = eread(state.obj_tags, ctx.target)
        pm = device_table(program, f.tag_mask, ctx.target.device)
        return actor_ok & (ctx.target >= 0) & (at & tt & pm).any(dim=-1)
    if f.kind == "game_value":
        # Value, then threshold, both always evaluated
        # (handler/filters/game_value_filter.hpp).
        value = eval_value(program, state, f.value, slot, ctx, mtd)
        threshold = eval_value(program, state, f.threshold, slot, ctx, mtd)
        return value >= threshold
    B = tuple(ctx.actor.shape)
    # An [E] per-env result broadcast over the rest of the batch shape.
    per_env = (B[0],) + (1,) * (len(B) - 1)
    if f.kind == "max_distance":
        r2 = f.radius * f.radius
        if f.query is not None:
            # Unary: the entity lies within the radius of any query result.
            qmask = eval_query_mask(program, state, f.query, ctx, mtd)  # [E, N]
            dr = state.obj_r.reshape(per_env + (-1,)) - gather(state.obj_r, slot)[..., None]
            dc = state.obj_c.reshape(per_env + (-1,)) - gather(state.obj_c, slot)[..., None]
            within = (dr * dr + dc * dc) <= r2
            return (slot >= 0) & (within & qmask.reshape(per_env + (-1,))).any(dim=-1)
        if f.radius <= 0:
            return torch.ones(B, dtype=torch.bool, device=ctx.actor.device)
        # Binary: the target cell within the radius of the actor.
        dr = ctx.target_r - eread(state.obj_r, ctx.actor, True)
        dc = ctx.target_c - eread(state.obj_c, ctx.actor, True)
        return dr * dr + dc * dc <= r2
    if f.kind == "not":
        return ~eval_filter(program, state, ctx, f.inner[0], mtd)
    if f.kind == "or":
        ok = torch.zeros(B, dtype=torch.bool, device=ctx.actor.device)
        for sub in f.inner:
            if mtd is None:
                ok = ok | eval_filter(program, state, ctx, sub)
            else:
                # OrFilter short-circuits: a sub runs, and draws, only where
                # no earlier sub passed.
                with mtd.narrowed(_env_gate(~ok, "all")):
                    ok = ok | eval_filter(program, state, ctx, sub, mtd)
        return ok
    if f.kind == "periodic":
        t = ctx.bcast_timestep()
        return (t >= f.start_on) & (torch.remainder(t - f.start_on, f.period) == 0)
    if f.kind == "query_resource":
        # The query results' summed inventories meet every minimum
        # (handler/filters/query_resource_filter.hpp:26-43).
        qmask = eval_query_mask(program, state, f.query, ctx, mtd)  # [E, N]
        ok = torch.ones(B, dtype=torch.bool, device=ctx.actor.device)
        for rid, amount in f.resource_mins:
            total = torch.where(qmask, state.obj_inv[..., rid], 0).sum(dim=-1)  # [E]
            ok = ok & (total.reshape(per_env) >= amount)
        return ok
    raise NotImplementedError(f"filter kind {f.kind!r} is not ported yet")


def eval_filters(program, state, ctx: Ctx, filters, mtd=None) -> torch.Tensor:
    """All filters of a chain. With a draw source, a filter's draws are gated
    on every earlier filter passing (C++ chains short-circuit); the result
    is computed everywhere."""
    ok = torch.ones(ctx.actor.shape, dtype=torch.bool, device=ctx.actor.device)
    for f in filters:
        if mtd is None:
            ok = ok & eval_filter(program, state, ctx, f)
        else:
            with mtd.narrowed(_env_gate(ok, "all")):
                ok = ok & eval_filter(program, state, ctx, f, mtd)
    return ok


# =====================================================================
# Queries (reference: core/query_system.cpp:177-280)
# =====================================================================


def _object_ctx(program, state, ctx: Optional[Ctx]) -> Ctx:
    """A per-object context [E, N] whose target is each object (query filter
    semantics: the candidate is the target, the actor is inherited —
    query_system.cpp:41-42)."""
    E, N = state.obj_type.shape
    dev = state.obj_type.device
    slots = torch.arange(N, dtype=_I32, device=dev)[None, :].expand(E, N)
    if ctx is not None and ctx.actor.dim() == 1:
        actor = ctx.actor[:, None].expand(E, N)
    else:
        actor = torch.full((E, N), -1, dtype=_I32, device=dev)
    return Ctx(
        actor=actor,
        target=slots,
        target_r=state.obj_r,
        target_c=state.obj_c,
        distance=torch.zeros((E, N), dtype=_I32, device=dev),
        timestep=state.step_count,
    )


def _env_slots(state, ctx: Optional[Ctx]) -> torch.Tensor:
    """Per-env [E] entity binding for env-level game values: the calling
    actor when the context is env-shaped, else no entity."""
    if ctx is not None and ctx.actor.dim() == 1:
        return ctx.actor
    E = state.obj_type.shape[0]
    return torch.full((E,), -1, dtype=_I32, device=state.obj_type.device)


def query_cap(program, state, q: CompiledQuery, E: int, N: int, ctx: Optional[Ctx], mtd) -> Optional[torch.Tensor]:
    """The max_items cap int32[E] of a query (-1 resolves to N), or None
    when it has none."""
    if q.max_items_value is not None:
        v = eval_value(program, state, q.max_items_value, _env_slots(state, ctx), ctx, mtd)  # [E]
        return torch.where(v < 0, float(N), torch.floor(v)).to(_I32)  # -1 = unlimited
    if q.max_items > 0:
        return torch.full((E,), q.max_items, dtype=_I32, device=state.obj_type.device)
    return None


def _apply_query_limits(program, state, q: CompiledQuery, mask: torch.Tensor, ctx: Optional[Ctx], mtd=None) -> torch.Tensor:
    """Cap the result mask at max_items objects (query_system.cpp:75-87),
    kept in ascending slot order, the engine's analogue of the reference's
    registration order.

    order_by=random picks the survivors at random. With an MtThread (the
    reference-RNG step) it draws a libstdc++ std::shuffle of the result
    vector from the MT19937 twin where mtd.active, then resolves max_items
    (the C++ order: the shuffle happens even uncapped, before the resize's
    game-value read), bit for bit. With a RankDraws it keeps each result
    with fewer than cap results of strictly smaller rank, among the query's
    ranks of this step (RankDraws.ranks), so tied ranks survive together as
    in the reference (exec.py:779-783); like the reference's own rule
    outside that mode it deviates from the C++ stream."""
    E, N = mask.shape
    m = mask.to(_I32)
    rank = m.cumsum(dim=1, dtype=_I32) - m  # registration-order rank
    if q.order_random and isinstance(mtd, MtThread):
        mtd.mt, perm = shuffle_perm(mtd.mt, m.sum(dim=1), N, mtd.active)
        inv = perm.argsort(dim=1).to(_I32)  # rank -> shuffled position
        pos = inv.gather(1, rank.long())
        cap = query_cap(program, state, q, E, N, ctx, mtd)
        if cap is None:
            cap = torch.full((E,), N, dtype=_I32, device=mask.device)
        # resize() keeps the first cap entries of the shuffled vector; where
        # the thread is inactive no draw happened: registration order there.
        return mask & (torch.where(mtd.active[:, None], pos, rank) < cap[:, None])
    cap = query_cap(program, state, q, E, N, ctx, mtd)
    if cap is None:
        return mask
    if q.order_random:
        if not isinstance(mtd, RankDraws):
            raise ValueError("an order_by=random query needs a draw source (MtThread or RankDraws)")
        ranks = torch.where(mask, mtd.ranks(q.rng_salt, E, N, mask.device), float("inf"))
        # before[e, i] = #(ranks[e] < ranks[e, i]): the left insertion point
        # of each rank in the sorted ranks.
        before = torch.searchsorted(ranks.sort(dim=1).values, ranks, side="left")
        return mask & (before < cap[:, None])
    return mask & (rank < cap[:, None])


def eval_query_mask(program, state, q: CompiledQuery, ctx: Optional[Ctx] = None, mtd=None) -> torch.Tensor:
    """A query as a bool[E, N] object mask, max_items applied."""
    mask = eval_query_mask_unlimited(program, state, q, ctx, mtd)
    return _apply_query_limits(program, state, q, mask, ctx, mtd)


def eval_query_mask_unlimited(program, state, q: CompiledQuery, ctx: Optional[Ctx] = None, mtd=None) -> torch.Tensor:
    """The query's mask before max_items (query_system.cpp:177-330). Nested
    queries (a filtered or closure source, closure candidates, a raycast
    source, a value's query) take ``mtd`` as the reference threads it. The
    query's own filters, edge filters and blockers run densely, per
    candidate in the C++ engine: they never ride an MtThread
    (rng_dep.reference_rng_unsupported refuses filters that would draw
    there), and outside the reference-RNG step they draw from a RankDraws
    as every other evaluation does."""
    dense = mtd if isinstance(mtd, RankDraws) else None
    if q.kind == "tag":
        mask = state.obj_alive & state.obj_tags[..., q.tag_id]
    elif q.kind == "filtered":
        mask = eval_query_mask(program, state, q.source, ctx, mtd)
    elif q.kind == "closure":
        if q.candidates is None:
            return eval_query_mask(program, state, q.source, ctx, mtd)
        mask = _closure(program, state, q, ctx, mtd, dense) & state.obj_alive
    elif q.kind == "raycast":
        return _raycast(program, state, q, ctx, mtd, dense)
    else:
        raise NotImplementedError(f"query kind {q.kind!r}")
    if q.filters:
        mask = mask & eval_filters(program, state, _object_ctx(program, state, ctx), q.filters, dense)
    return mask


def _closure(program, state, q: CompiledQuery, ctx: Optional[Ctx], mtd, dense) -> torch.Tensor:
    """The closure's reach before its result filters: a bounded BFS of
    max_hops rounds from the source's results through the candidates', an
    edge where the squared distance is at most max_distance2 and every edge
    filter passes with actor = the member, target = the candidate. The
    [E, N, N] edge context is built of broadcast views (Ctx.pair_identity);
    only the adjacency and the filters' results are materialized."""
    roots = eval_query_mask(program, state, q.source, ctx, mtd)
    pool = eval_query_mask(program, state, q.candidates, ctx, mtd)
    E, N = state.obj_type.shape
    dev = state.obj_type.device
    d2 = state.obj_r[:, :, None] - state.obj_r[:, None, :]
    d2.mul_(d2)
    dc = state.obj_c[:, :, None] - state.obj_c[:, None, :]
    d2.add_(dc.mul_(dc))
    del dc
    adj = d2 <= q.max_distance2  # [E, source, candidate]
    del d2
    if q.edge_filters:
        iota = torch.arange(N, dtype=_I32, device=dev)
        ectx = Ctx(
            actor=iota[None, :, None].expand(E, N, N),
            target=iota[None, None, :].expand(E, N, N),
            target_r=state.obj_r[:, None, :].expand(E, N, N),
            target_c=state.obj_c[:, None, :].expand(E, N, N),
            distance=torch.zeros((), dtype=_I32, device=dev).expand(E, N, N),
            timestep=state.step_count,
            pair_identity=True,
        )
        adj &= eval_filters(program, state, ectx, q.edge_filters, dense)
    adj &= (pool & state.obj_alive)[:, None, :]
    reach = roots
    for _ in range(q.max_hops):
        reach = reach | (reach[:, :, None] & adj).any(dim=1)
    return reach


def _raycast(program, state, q: CompiledQuery, ctx: Optional[Ctx], mtd, dense) -> torch.Tensor:
    """Rays from the source's results (query_system.cpp:258-330): each
    direction walks max_hops cells, or with a game-value range (max_range_value)
    max(H, W) cells masked past the per-env range. The ray stops at the
    grid's edge and after the first object that is a blocker (any one of
    the query's filters); every object met before is a hit, and the blocker
    too with include_blocker. Reads state.grid, so the step keeps the grid's
    agent layer current wherever a raycast is reachable
    (actions_fast.reads_grid).

    The rays of every source, direction and hop are one [E, k, D, L] batch
    (k: the most sources of any env, read to the host once): the ray's
    state before hop i is the out-of-grid test at i (a straight ray that
    leaves the grid stays out) and whether some earlier hop met a
    blocker."""
    E, N = state.obj_type.shape
    H, W = state.grid.shape[1], state.grid.shape[2]
    dev = state.obj_type.device
    sources = eval_query_mask(program, state, q.source, ctx, mtd)  # [E, N]
    octx = _object_ctx(program, state, ctx)
    is_blocker = torch.zeros((E, N), dtype=torch.bool, device=dev)
    for f in q.filters:
        is_blocker = is_blocker | eval_filter(program, state, octx, f, dense)
    if q.max_range_value is not None:
        L = max(H, W)
        rng_val = eval_value(program, state, q.max_range_value, _env_slots(state, ctx), ctx, mtd)  # [E]
    else:
        L, rng_val = q.max_hops, None
    hits = torch.zeros((E, N + 1), dtype=torch.bool, device=dev)  # column N: a spare for masked-off hits
    k = trace.host_read(sources.sum(dim=1).max(), "query.raycast_sources", int) if L > 0 and q.directions else 0
    if k > 0:
        iota = torch.arange(N, dtype=_I32, device=dev)
        src = torch.where(sources, iota, N).sort(dim=1).values[:, :k]  # the first k source slots, N past the last
        dirs = list(q.directions)
        dr = device_table(program, np.asarray(DIR_DR)[dirs].astype(np.int32), dev)
        dc = device_table(program, np.asarray(DIR_DC)[dirs].astype(np.int32), dev)
        hop = torch.arange(1, L + 1, dtype=_I32, device=dev)
        steps_r = (dr[:, None] * hop)[None, None]  # [1, 1, D, L]
        steps_c = (dc[:, None] * hop)[None, None]
        s = src.clamp(max=N - 1)
        rr = gather(state.obj_r, s)[..., None, None] + steps_r  # [E, k, D, L]
        cc = gather(state.obj_c, s)[..., None, None] + steps_c
        inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
        slot = grid_read(state.grid, rr, cc)
        occupied = inb & (slot >= 0)
        blocks = torch.gather(is_blocker, 1, slot.reshape(E, -1).clamp(0, N - 1).long()).reshape(slot.shape)
        stop = (occupied & blocks).to(_I32)
        stopped = (stop.cumsum(dim=-1, dtype=_I32) - stop) > 0  # a blocker at an earlier hop
        live = occupied & ~stopped & (src < N)[..., None, None]
        if rng_val is not None:
            live = live & (hop.to(torch.float32) <= rng_val[:, None, None, None])
        hit = live if q.include_blocker else live & ~blocks
        hits.scatter_(1, torch.where(hit, slot, N).reshape(E, -1).long(), True)
    return hits[:, :N] & state.obj_alive
