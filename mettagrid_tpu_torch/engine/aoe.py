"""Per-tick area effects (reference: core/aoe_tracker.{hpp,cpp}).

Fixed and mobile sources collapse into one [E, N, A] distance mask per AOE
spec. Presence deltas are edge-triggered on the ``aoe_inside`` mask carried
in EnvState and applied per source, sources in slot order (their
registration order) and each source's specs in spec order, each clamped on
its own, as the reference applies them while it walks the sources. Per-tick resource deltas on the
target net across every source of every spec and are applied once, after
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

from mettagrid_tpu_torch.engine.exec import Ctx, eval_filters, inv_update
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


def make_aoe_phase(program: EngineProgram, init: EnvInit):
    """Returns aoe_phase(state, draws=None) -> state, or None when there are
    no AOE specs. draws: the draw source of order_by=random queries in the
    specs' filters and mutations (exec.RankDraws), evaluated densely as the
    reference evaluates them (its exec.py:770-783). init: the map pool. Where
    no phase writes an object's type, the most slots of a pool map whose type
    has an AOE with presence deltas bounds the sources walked for them; where
    one may, their number is read back each step."""
    specs = program.aoe_specs
    if not specs:
        return None
    A = program.num_agents
    # Only specs that draw take the draw source (which gates every filter).
    draw = any(filter_consumes(f, program) for s in specs for f in s.filters) or any(
        mutation_consumes(m, program) for s in specs for m in s.mutations)
    presence_types = sorted({s.type_id for s in specs if s.presence})
    presence_sources = None
    if presence_types and "obj_type" not in maybe_written_pool_fields(program):
        presence_sources = int(np.isin(init.obj_type, presence_types).sum(axis=1).max())

    def aoe_phase(state: EnvState, draws=None) -> EnvState:
        draws = draws if draw else None
        E, N = state.obj_type.shape
        dev = state.obj_type.device
        src_slots = torch.arange(N, dtype=torch.int32, device=dev)[None, :, None].expand(E, N, A)
        agt_slots = torch.arange(A, dtype=torch.int32, device=dev)[None, None, :].expand(E, N, A)
        # Source -> agent squared distances [E, N, A].
        dr = state.obj_r[:, :, None] - state.obj_r[:, None, :A]
        dc = state.obj_c[:, :, None] - state.obj_c[:, None, :A]
        d2 = dr * dr + dc * dc
        inside = []
        pending = {}  # rid -> int32[E, A]: the per-tick deltas of every spec, applied once
        for k, spec in enumerate(specs):
            trace.count("aoe.pairs", E * N * A)  # the (source slot, agent) pairs this spec evaluates
            source = state.obj_alive & (state.obj_type == spec.type_id)  # [E, N]
            cand = source[:, :, None] & (d2 <= spec.radius * spec.radius)
            if not spec.effect_self:
                cand = cand & (src_slots != agt_slots)
            ctx = Ctx(
                actor=src_slots,
                target=agt_slots,
                target_r=state.obj_r[:, None, :A].expand(E, N, A),
                target_c=state.obj_c[:, None, :A].expand(E, N, A),
                distance=torch.zeros((), dtype=torch.int32, device=dev).expand(E, N, A),
                timestep=state.step_count,
            )
            passes = cand & eval_filters(program, state, ctx, spec.filters, draws)
            inside.append(passes)

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
                state = _apply_general_mutations(program, state, general, passes, n_pass, A, draws)
        if presence_types:
            state = _presence_per_source(program, state, inside, presence_types, presence_sources)
        state = _agent_inv_updates(program, state, [(((rid, 1),), d) for rid, d in sorted(pending.items())])
        return state._replace(aoe_inside=torch.stack(inside, dim=1))

    return aoe_phase


def _presence_per_source(program, state, inside, presence_types, J):
    """Presence deltas where an agent entered (+) or left (-) a source's reach
    since the last step, source by source in slot order and, for each, its
    specs in spec order. The candidate sources of an env are its slots of a
    type whose AOE has presence deltas, and those an agent was inside of; J
    bounds their number, or, where it is None, the most of them in any env is
    read back."""
    E, N = state.obj_type.shape
    was = state.aoe_inside  # [E, K, N, A]
    specs = [(k, spec) for k, spec in enumerate(program.aoe_specs) if spec.presence]
    cand = state.obj_type == presence_types[0]
    for t in presence_types[1:]:
        cand = cand | (state.obj_type == t)
    for k, _ in specs:
        cand = cand | was[:, k].any(dim=2)
    if J is None:
        J = trace.host_read(cand.sum(dim=1).max(), "aoe.presence_sources", int)
    J = min(J, N)
    # The candidates first, in slot order; the rest have no edge.
    src = torch.sort((~cand).to(torch.uint8), dim=1, stable=True).indices[:, :J, None]
    src = src.expand(E, J, program.num_agents)

    def edge(k):  # int32[E, J, A]: +1 entered, -1 left
        return torch.gather(inside[k], 1, src).to(torch.int32) - torch.gather(was[:, k], 1, src).to(torch.int32)

    edges = [(spec, edge(k)) for k, spec in specs]
    return _agent_inv_updates(program, state, [(spec.presence, e[:, j]) for j in range(J) for spec, e in edges])


def _apply_general_mutations(program, state, mutations, passes, n_pass, A, draws=None):
    """Run the mutation chain per (source, agent) passing pair.

    The reference applies each AOE source's mutations per target with actor
    = source and target = agent (aoe_tracker.cpp:99-115), per target in
    agent order, sources in registration order. Here wave w binds each
    agent's (w+1)-th passing source (ascending slot) as its actor, and the
    agents apply in order inside each wave. The number of waves, the largest
    number of sources passing one agent, is read back to the host once per
    call: this phase's one host read, made only for specs with such
    mutations. Filters were evaluated at phase start (batch semantics; the
    reference re-checks per pair mid-traversal)."""
    E = passes.shape[0]
    dev = passes.device
    csum = passes.to(torch.int32).cumsum(dim=1)  # [E, N, A]
    for w in range(trace.host_read(n_pass.max(), "aoe.source_waves", int)):
        sel = passes & (csum == w + 1)  # [E, N, A]: one source per agent at most
        actor_slot = sel.to(torch.int8).argmax(dim=1).to(torch.int32)  # [E, A]
        has = sel.any(dim=1)  # [E, A]
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
