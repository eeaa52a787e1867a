"""Per-tick area effects (reference: core/aoe_tracker.{hpp,cpp}).

Fixed and mobile sources collapse into one [E, X, A] distance mask per AOE
spec: X its type's slots where no phase writes an object's type (the pool
bounds them), else every slot N. Presence deltas are edge-triggered on the
``aoe_inside`` mask carried in EnvState and applied per source, sources in
slot order (their registration order) and each source's specs in spec
order, each clamped on its own, as the reference applies them while it
walks the sources. Per-tick resource deltas on the target net across every source of every spec and are applied once, after
the presence deltas (the reference's deferred-delta batch,
aoe_tracker.cpp:282-361). Every other mutation kind runs per (source, agent)
pair (_apply_general_mutations). Filters and those mutations see the state
as the specs before them left it; the deferred deltas and the presence
deltas are not yet in it. The JAX engine's engine/aoe.py nets presence
deltas per agent and clamps each spec's per-tick deltas on their own; the
two agree wherever no clamp binds.
"""

from __future__ import annotations

import numpy as np
import torch

from mettagrid_tpu_torch.engine.exec import Ctx, eval_filters, gather, inv_update
from mettagrid_tpu_torch.engine.handlers import apply_mutation, emit_inv_stats
from mettagrid_tpu_torch.engine.init import EnvInit
from mettagrid_tpu_torch.engine.mutfields import maybe_written_pool_fields
from mettagrid_tpu_torch.engine.program import EngineProgram
from mettagrid_tpu_torch.engine.rng_dep import filter_consumes, mutation_consumes
from mettagrid_tpu_torch.engine.state import EnvState
from mettagrid_tpu_torch.profiling import trace

# Mutation kinds with exact vectorized paths in aoe_phase (resource_delta
# only on the target); the rest run _apply_general_mutations.
FAST_KINDS = frozenset({"change_vibe", "add_tag", "remove_tag"})


def general_mutations(spec):
    """The mutations of an AOE spec that run per (source, agent) pair."""
    return [
        m for m in spec.mutations
        if m.kind not in FAST_KINDS and not (m.kind == "resource_delta" and not m.target_is_actor)
    ]


def _agent_inv_updates(program, state, updates):
    """Applies each (deltas, scale) of ``updates`` in turn to the agents'
    inventories: scale * delta of each (rid, delta), where scale (int32[E, A])
    is not 0, each update clamped on its own and emitting its inventory
    stats."""
    if not updates:
        return state
    A = program.num_agents
    tid = state.obj_type[:, :A]
    inv = state.obj_inv[:, :A]
    for deltas, scale in updates:
        before, mask = inv, scale != 0
        for rid, delta in deltas:
            inv, _ = inv_update(program, tid, inv, rid, delta * scale, mask)
        state = emit_inv_stats(program, state, None, inv - before, inv, mask, actor_prefix=True)
    obj_inv = state.obj_inv.clone()
    obj_inv[:, :A] = inv
    return state._replace(obj_inv=obj_inv)


def _type_mask(obj_type, types):
    """bool[E, N]: the slots whose type is one of ``types``."""
    mask = obj_type == types[0]
    for t in types[1:]:
        mask = mask | (obj_type == t)
    return mask


def _first_slots(mask, J):
    """The first J slots of each env where ``mask`` (bool[E, N]) holds, in
    ascending order, N past the last: int32[E, J]."""
    E, N = mask.shape
    iota = torch.arange(N, dtype=torch.int32, device=mask.device)
    return torch.where(mask, iota, N).topk(J, dim=1, largest=False).values


def make_aoe_phase(program: EngineProgram, init: EnvInit):
    """Returns aoe_phase(state, draws=None) -> state, or None when there are
    no AOE specs. draws: the draw source of order_by=random queries in the
    specs' filters and mutations (exec.RankDraws), evaluated densely as the
    reference evaluates them (its exec.py:770-783). init: the map pool.

    Where no phase writes an object's type, each spec runs over its type's
    slots alone: the most slots of that type in any pool map bound them, and
    each env's are taken in slot order, padded with N, so a spec evaluates
    [E, J, A] (source, agent) pairs; the sources with presence deltas are
    bounded the same way. Where a phase may write a type, every slot is a
    source slot ([E, N, A]) and the number of sources with presence deltas
    is read back each step."""
    specs = program.aoe_specs
    if not specs:
        return None
    A = program.num_agents
    K = len(specs)
    # Only specs that draw take the draw source (which gates every filter).
    draw = any(filter_consumes(f, program) for s in specs for f in s.filters) or any(
        mutation_consumes(m, program) for s in specs for m in s.mutations)
    presence_types = tuple(sorted({s.type_id for s in specs if s.presence}))
    bound = None  # types -> the most slots of those types in any pool map
    if "obj_type" not in maybe_written_pool_fields(program):
        listed_types = {(s.type_id,) for s in specs} | ({presence_types} if presence_types else set())
        bound = {types: int(np.isin(init.obj_type, types).sum(axis=1).max()) for types in listed_types}

    def aoe_phase(state: EnvState, draws=None) -> EnvState:
        draws = draws if draw else None
        E, N = state.obj_type.shape
        dev = state.obj_type.device
        # Sources reach from where they stood when the phase began.
        r0, c0 = state.obj_r, state.obj_c
        listed = {}

        def slots_of(types):  # (int32[E, X] source slots, bool[E, X] real slots of those types)
            if bound is None:
                slots = torch.arange(N, dtype=torch.int32, device=dev)[None, :].expand(E, N)
                return slots, _type_mask(state.obj_type, types)
            if types not in listed:
                slots = _first_slots(_type_mask(state.obj_type, types), bound[types])
                listed[types] = slots, slots < N
            return listed[types]

        inside = []  # (slots, real, passes bool[E, X, A]) per spec
        pending = {}  # rid -> int32[E, A]: the per-tick deltas of every spec, applied once
        for spec in specs:
            slots, real = slots_of((spec.type_id,))
            X = slots.shape[1]
            trace.count("aoe.pairs", E * X * A)  # the (source slot, agent) pairs this spec evaluates
            src_slots = slots[:, :, None].expand(E, X, A)
            agt_slots = torch.arange(A, dtype=torch.int32, device=dev)[None, None, :].expand(E, X, A)
            dr = gather(r0, slots)[:, :, None] - r0[:, None, :A]
            dc = gather(c0, slots)[:, :, None] - c0[:, None, :A]
            source = real & gather(state.obj_alive, slots)  # [E, X]
            cand = source[:, :, None] & (dr * dr + dc * dc <= spec.radius * spec.radius)
            if not spec.effect_self:
                cand = cand & (src_slots != agt_slots)
            ctx = Ctx(
                actor=src_slots,
                target=agt_slots,
                target_r=state.obj_r[:, None, :A].expand(E, X, A),
                target_c=state.obj_c[:, None, :A].expand(E, X, A),
                distance=torch.zeros((), dtype=torch.int32, device=dev).expand(E, X, A),
                timestep=state.step_count,
            )
            passes = cand & eval_filters(program, state, ctx, spec.filters, draws)
            inside.append((slots, real, passes))

            # Per-tick mutations: target resource deltas scale with the number
            # of passing sources, idempotent kinds apply once when any passes.
            n_pass = passes.sum(dim=1, dtype=torch.int32)  # [E, A]
            any_pass = n_pass > 0
            for m in spec.mutations:
                if m.kind == "resource_delta" and not m.target_is_actor:
                    for rid, delta in m.deltas:
                        pending[rid] = pending.get(rid, 0) + delta * n_pass
                elif m.kind == "change_vibe":
                    vibe = state.obj_vibe.clone()
                    vibe[:, :A] = torch.where(any_pass, m.vibe_id, vibe[:, :A])
                    state = state._replace(obj_vibe=vibe)
                elif m.kind in ("add_tag", "remove_tag"):
                    tags = state.obj_tags.clone()
                    tags[:, :A, m.tag_id] = torch.where(any_pass, m.kind == "add_tag", tags[:, :A, m.tag_id])
                    state = state._replace(obj_tags=tags)
            general = general_mutations(spec)
            if general:
                state = _apply_general_mutations(program, state, general, slots, passes, n_pass, A, draws)
        if bound is None:
            now = torch.stack([passes for _, _, passes in inside], dim=1)
        else:
            # Every source's rows at its slot of [E, K, N, A], padding in a
            # spare last row.
            flat = torch.zeros((E * K * N + 1, A), dtype=torch.bool, device=dev)
            env_rows = torch.arange(E, device=dev)[:, None] * (K * N)
            for k, (slots, real, passes) in enumerate(inside):
                rows = torch.where(real, env_rows + (k * N) + slots, E * K * N)
                flat[rows.reshape(-1)] = passes.reshape(-1, A)
            now = flat[:-1].view(E, K, N, A)
        if presence_types:
            if bound is None:
                src, real = _presence_candidates(program, state, presence_types), None
            else:
                src, real = slots_of(presence_types)
            state = _presence_per_source(program, state, now, src, real)
        state = _agent_inv_updates(program, state, [(((rid, 1),), d) for rid, d in sorted(pending.items())])
        return state._replace(aoe_inside=now)

    return aoe_phase


def _presence_candidates(program, state, presence_types):
    """Where a phase may write an object's type: each env's slots of a type
    whose AOE has presence deltas, and those an agent was inside of, first in
    slot order; their most in any env is read back. int64[E, J]."""
    was = state.aoe_inside  # [E, K, N, A]
    cand = _type_mask(state.obj_type, presence_types)
    for k, spec in enumerate(program.aoe_specs):
        if spec.presence:
            cand = cand | was[:, k].any(dim=2)
    J = trace.host_read(cand.sum(dim=1).max(), "aoe.presence_sources", int)
    # The candidates first, in slot order; the rest have no edge.
    return torch.sort((~cand).to(torch.uint8), dim=1, stable=True).indices[:, :J]


def _presence_per_source(program, state, now, src, real):
    """Presence deltas where an agent entered (+) or left (-) a source's reach
    since the last step, source by source in slot order and, for each, its
    specs in spec order. now: this step's aoe_inside [E, K, N, A]; src
    [E, J]: the candidate source slots of each env in slot order; real
    (bool[E, J], or None where every entry is a slot): which are slots, the
    rest padding with no edge."""
    E, J = src.shape
    was = state.aoe_inside  # [E, K, N, A]
    N = was.shape[2]
    idx = src.long().clamp(max=N - 1)[:, :, None].expand(E, J, program.num_agents)

    def edge(k):  # int32[E, J, A]: +1 entered, -1 left
        e = torch.gather(now[:, k], 1, idx).to(torch.int32) - torch.gather(was[:, k], 1, idx).to(torch.int32)
        return e if real is None else e * real[:, :, None]

    edges = [(spec, edge(k)) for k, spec in enumerate(program.aoe_specs) if spec.presence]
    return _agent_inv_updates(program, state, [(spec.presence, e[:, j]) for j in range(J) for spec, e in edges])


def _apply_general_mutations(program, state, mutations, slots, passes, n_pass, A, draws=None):
    """Run the mutation chain per (source, agent) passing pair.

    The reference applies each AOE source's mutations per target with actor
    = source and target = agent (aoe_tracker.cpp:99-115), per target in
    agent order, sources in registration order. Here wave w binds each
    agent's (w+1)-th passing source (ascending slot; slots int32[E, X] are
    the sources of passes [E, X, A], in slot order) as its actor, and the
    agents apply in order inside each wave. The number of waves, the largest
    number of sources passing one agent, is read back to the host once per
    call: this phase's one host read, made only for specs with such
    mutations. Filters were evaluated at phase start (batch semantics; the
    reference re-checks per pair mid-traversal)."""
    E = passes.shape[0]
    dev = passes.device
    csum = passes.to(torch.int32).cumsum(dim=1)  # [E, X, A]
    for w in range(trace.host_read(n_pass.max(), "aoe.source_waves", int)):
        sel = passes & (csum == w + 1)  # [E, X, A]: one source per agent at most
        j = sel.to(torch.int8).argmax(dim=1)  # [E, A]
        has = sel.any(dim=1)  # [E, A]
        actor_slot = torch.where(has, torch.gather(slots, 1, j), 0)  # slot 0 where none, as argmax gives
        for a in range(A):
            ctx = Ctx(
                actor=actor_slot[:, a],
                target=torch.full((E,), a, dtype=torch.int32, device=dev),
                target_r=state.obj_r[:, a],
                target_c=state.obj_c[:, a],
                distance=torch.zeros((E,), dtype=torch.int32, device=dev),
                timestep=state.step_count,
            )
            for m in mutations:
                state, _ = apply_mutation(program, state, ctx, m, has[:, a], draws)
    return state
