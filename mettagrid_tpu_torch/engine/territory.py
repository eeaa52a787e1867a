"""Territory influence zones (reference: core/territory_tracker.{hpp,cpp},
docs/territory.md:74-88).

Counterpart of the reference's engine/territory.py. Sources project integer
influence 1024*strength decayed by Euclidean distance; each point's owner in
a territory is the arg-max of the per-tag score sums, ties neutral. The
enter, exit and presence handlers fire with the actor replaced by a proxy
that carries only the winning tag (``Ctx.actor_tags``).

Scores are summed over the emitting sources only: each call reads their
largest count per env back to the host once (an alive object of a type with
territory strength that has a tag under the prefix), so the [E, sources,
points] tensors stay small where few objects emit. Every sum is an int32
sum, exact like the reference's integer einsum.
"""

from __future__ import annotations

import numpy as np
import torch

from mettagrid_tpu_torch.engine.exec import Ctx, device_table, eval_filters, type_select
from mettagrid_tpu_torch.engine.handlers import apply_mutations
from mettagrid_tpu_torch.engine.rng_dep import handler_consumes
from mettagrid_tpu_torch.engine.program import EngineProgram
from mettagrid_tpu_torch.engine.state import EnvState
from mettagrid_tpu_torch.profiling import trace

INFLUENCE_SCALE = 1024


def check_territories(program: EngineProgram) -> None:
    """Raise ValueError for a territory whose prefix names no tag: no point
    could ever be owned, and the reference fails on its empty tag table
    while tracing the step."""
    for spec in program.territories:
        if not spec.prefix_tag_ids:
            raise ValueError(
                f"territory {spec.name!r}: no tag of the game has its tag prefix, so it can own no cell; "
                "give some object or agent a tag under the prefix"
            )


def _scaled_distance(d2: torch.Tensor) -> torch.Tensor:
    """floor(1024 * sqrt(d2)) with the reference's integer fix-up, op for op
    in float32 (territory.py:29-37) so that it rounds as the reference does."""
    d2f0 = d2.to(torch.float32)
    s = torch.floor(INFLUENCE_SCALE * torch.sqrt(d2f0)).to(torch.int32)
    f = s.to(torch.float32)
    d2f = d2f0 * (INFLUENCE_SCALE * INFLUENCE_SCALE)
    s = torch.where((f + 1.0) * (f + 1.0) <= d2f, s + 1, s)
    return torch.where(f * f > d2f, s - 1, s)


def territory_scores(program: EngineProgram, state: EnvState, ti: int, pr: torch.Tensor, pc: torch.Tensor):
    """Per-point per-prefix-tag influence sums int32[E, P, Tt] at the points
    pr, pc int32[E, P], and the tag ids under the prefix (Tt of them)."""
    spec = program.territories[ti]
    tag_ids = spec.prefix_tag_ids
    Tt = len(tag_ids)
    E, P = pr.shape
    tid = state.obj_type
    strength = type_select(program, tid, spec.type_strength)  # [E, N]
    decay = type_select(program, tid, spec.type_decay)
    # The source's tag: the FIRST prefix tag it has (territory_tracker.cpp:208-213).
    src_tag = torch.full_like(tid, -1)
    for i in reversed(range(Tt)):
        src_tag = torch.where(state.obj_tags[:, :, tag_ids[i]], i, src_tag)
    emits = state.obj_alive & (strength > 0) & (src_tag >= 0)
    M = trace.host_read(emits.sum(dim=1).max(), "territory.emitters", int) if E else 0  # the one host read
    trace.count("territory.points", E * P * M)  # (point, emitter) pairs scored
    if M == 0:
        return torch.zeros((E, P, Tt), dtype=torch.int32, device=pr.device), tag_ids
    # The emitting slots first, in slot order; the sums are exact in any order.
    src = torch.sort((~emits).to(torch.uint8), dim=1, stable=True).indices[:, :M]

    def pick(x):
        return torch.gather(x, 1, src)

    dr = pick(state.obj_r)[:, :, None] - pr[:, None, :]  # [E, M, P]
    dc = pick(state.obj_c)[:, :, None] - pc[:, None, :]
    sd = _scaled_distance(dr * dr + dc * dc)
    # score = max(0, strength*1024 - decay*floor(1024*sqrt(d2))) (territory_tracker.cpp:40-50)
    score = (pick(strength)[:, :, None] * INFLUENCE_SCALE - pick(decay)[:, :, None] * sd).clamp(min=0)
    score = torch.where(pick(emits)[:, :, None], score, 0)
    tag_of = pick(src_tag)[:, :, None]
    scores = [torch.where(tag_of == t, score, 0).sum(dim=1, dtype=torch.int32) for t in range(Tt)]
    return torch.stack(scores, dim=-1), tag_ids


def cell_ownership(program: EngineProgram, state: EnvState, ti: int, pr: torch.Tensor, pc: torch.Tensor):
    """The winning prefix-tag index per point, int32[E, P] (-1 neutral or
    tied), and the tag ids under the prefix."""
    scores, tag_ids = territory_scores(program, state, ti, pr, pc)
    best = scores.max(dim=-1).values
    winner = scores.argmax(dim=-1).to(torch.int32)
    tied = (scores == best[..., None]).sum(dim=-1) > 1
    return torch.where((best > 0) & ~tied, winner, -1), tag_ids


def owner_tag(program: EngineProgram, state: EnvState, ti: int, pr: torch.Tensor, pc: torch.Tensor):
    """The tag id owning each point in territory ti, int32[E, P] (-1 none)."""
    winner, tag_ids = cell_ownership(program, state, ti, pr, pc)
    table = device_table(program, np.asarray(tag_ids, dtype=np.int32), pr.device)
    return torch.where(winner >= 0, table[winner.clamp(min=0).long()], -1)


def winning_tags(program: EngineProgram, state: EnvState, pr: torch.Tensor, pc: torch.Tensor):
    """The tag owning each point in the first territory that owns it
    (territory_tracker.cpp:262-272), int32[E, P] (-1 none): the AOE mask
    observation's source."""
    win = torch.full(pr.shape, -1, dtype=torch.int32, device=pr.device)
    for ti in range(len(program.territories)):
        win = torch.where(win < 0, owner_tag(program, state, ti, pr, pc), win)
    return win


def one_hot_bool(tag: torch.Tensor, n_tags: int) -> torch.Tensor:
    """bool one-hot of tag ids, [..., n_tags] (-1 gives all False)."""
    return tag[..., None] == torch.arange(n_tags, dtype=tag.dtype, device=tag.device)


def make_territory_phase(program: EngineProgram):
    """Returns territory_phase(state, draws=None) -> state, which fires every
    territory's exit, enter and presence handlers per agent, or None when
    the program has no territories; order_by=random queries in them draw
    from ``draws`` (exec.RankDraws). Raises ValueError for a territory whose
    prefix names no tag."""
    if not program.territories:
        return None
    check_territories(program)
    A = program.num_agents
    n_tags = program.num_tags

    # Only handlers that draw take the draw source (which gates every filter).
    draw = any(handler_consumes(h, program) for t in program.territories for h in (t.on_enter, t.on_exit, t.presence))

    def territory_phase(state: EnvState, draws=None) -> EnvState:
        draws = draws if draw else None
        E = state.obj_type.shape[0]
        dev = state.obj_type.device
        agent_slots = torch.arange(A, dtype=torch.int32, device=dev)[None, :].expand(E, A)
        pr = state.obj_r[:, :A]
        pc = state.obj_c[:, :A]
        inside = []
        for ti, spec in enumerate(program.territories):
            cur_tag = owner_tag(program, state, ti, pr, pc)  # [E, A]
            prev_tag = state.territory_inside[:, ti]
            changed = cur_tag != prev_tag

            def proxy_ctx(tag):
                return Ctx(
                    actor=torch.full((E, A), -1, dtype=torch.int32, device=dev),
                    target=agent_slots,
                    target_r=pr,
                    target_c=pc,
                    distance=torch.zeros((E, A), dtype=torch.int32, device=dev),
                    timestep=state.step_count,
                    actor_tags=one_hot_bool(tag, n_tags),
                )

            for handler, tag, mask in (
                (spec.on_exit, prev_tag, changed & (prev_tag >= 0)),
                (spec.on_enter, cur_tag, changed & (cur_tag >= 0)),
                (spec.presence, cur_tag, cur_tag >= 0),
            ):
                if handler is not None:
                    ctx = proxy_ctx(tag)
                    passed = mask & eval_filters(program, state, ctx, handler.filters, draws)
                    state, _ = apply_mutations(program, state, ctx, handler, passed, draws)
            inside.append(cur_tag)
        return state._replace(territory_inside=torch.stack(inside, dim=1))

    return territory_phase
