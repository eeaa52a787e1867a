"""The launch plan of the persistent tails B1, B2, B3, B4, B5, B6a and B6b
(engine/kernels/tail_plan.py), a function of the shapes, at the bench
shapes and at the edges it branches on.

At full bench size (24 agents, 25x25 maps; arena_128 on 128x128 maps) the
obs function is built on the CPU and its route and tail shapes read: the
route stays B1/B2/B1/B3/B4/B4/B5/B6a/B6b for flagship/general/combat/
arena_128/arena_lp/arena_values/general_lp/flagship_v3/arena_mood_v3. Each
candidate plan fits one block's
shared memory; the plan kept is the one that leaves the most warps resident
per SM (here counted from shared memory alone; the wrapper asks the card,
which also counts registers), the one with the most stages on a tie. Images
or object tables that fit one stage but not two run with one; B6a stages
its paired halves in one stage at every size; images that leave no room for
the row buffers of WARPS warps run with fewer warps. B5 stages its per-env
image wherever a staged plan fits and holds, and reads it from device
memory otherwise; B3 and B6b read their image or paired halves from device
memory at every size, and B3 keeps at most 12 rounds in registers. B6a's
plan offsets carry the right half's distance. B4 plans B1's layout with v1
rows of any width and any number of globals (past 32 they take rounds of
their own). The persistent grid holds every
resident block and no more blocks than envs. Every kind's plans refuse
shapes they cannot hold, with the reason: rows that are not whole 16-byte
units (the v2 kinds), more than 32 globals (every kind but B4), offsets that
do not pack, more candidates than the largest compiled bucket of rounds.
The route never asks the card or the plan it would keep.
"""

import pytest

from mettagrid_tpu_torch.engine import obs as tobs
from mettagrid_tpu_torch.engine.kernels import tail_plan as tp
from mettagrid_tpu_torch.engine.step import step_obs_fn
from mettagrid_tpu_torch.tools import bench_run


def _one_image_and_tables(HP, WPC, K, S):
    """Bytes of one env's image int32[HP, WPC] and three candidate tables of
    K*S entries: the shapes' size beside one block's shared memory."""
    return (HP * WPC + 3 * K * S) * 4


def _smem_blocks_per_sm(plan):
    """Blocks per SM that shared memory alone allows: an H100 SM has 228 KB,
    1 KB of which each block reserves."""
    return 233472 // (plan.smem_bytes + 1024)


# variant -> (route, rounds, out_w, candidate stage counts, stages kept by
# the shared-memory count); 0 stages: the image read from device memory
BENCH = {
    "flagship": ("B1", 12, 256, [2, 1], 1),
    "general": ("B2", 24, 512, [2, 1], 2),
    "combat": ("B1", 32, 384, [2, 1], 1),
    "arena_128": ("B3", 12, 256, [0], 0),
    "arena_lp": ("B4", 12, 389, [1], 1),
    "arena_values": ("B4", 12, 437, [1], 1),  # 53 globals: two rounds of their own, the window's 12 planned
    "general_lp": ("B5", 24, 512, [2, 1], 1),
    "flagship_v3": ("B6a", 12, 256, [1], 1),
    "arena_mood_v3": ("B6b", 16, 384, [0], 0),
}


@pytest.mark.parametrize("variant", sorted(BENCH))
def test_bench_shapes_plan(variant):
    route, rounds, out_w, stage_counts, stages = BENCH[variant]
    program, init = bench_run.build_pool(bench_run.make_cfg(variant), 1)
    fn = step_obs_fn(program, init, "cpu", obs_tail=bench_run.variant_options(variant)["obs_tail"])
    assert fn.route == route
    sh = dict(fn.tail_shapes)
    fits = _one_image_and_tables(sh["HP"], sh["WPC"], sh["K"], sh["S"]) <= tobs.MAX_SMEM
    assert fits == (route != "B3")
    assert fn.out_w == out_w
    HP2 = sh.pop("HP2", None)
    assert (HP2 is not None) == (route in ("B6a", "B6b"))
    if HP2 is not None:  # B6a and B6b are planned on their paired halves, 2 * HP2 rows each
        sh["HP"] = 2 * HP2
    N = init.obj_type.shape[1]
    A, G, S = program.num_agents, sh["G"], sh["S"]
    plans = tp.candidate_plans(route, A=A, out_w=fn.out_w, N=N, **sh)
    assert [p.stages for p in plans] == stage_counts
    for p in plans:
        assert p.rounds == rounds == tp.rounds_for(G, sh["K"], S, route)
        # The plan holds every candidate; B4's past 32 globals take rounds of their own.
        assert 32 * p.rounds >= (0 if route == "B4" and G > 32 else G) + sh["K"] * S
        assert p.warps == min(tp.WARPS, A)
        assert p.smem_bytes == tp.smem_bytes(route, p.stages, p.warps, sh["HP"], sh["WPC"], fn.out_w, A, G, S, N)
        assert p.smem_bytes <= tp.MAX_SMEM
    assert tp.choose(plans, _smem_blocks_per_sm).stages == stages


@pytest.mark.parametrize("kind,HP,WPC,N,stages", [
    ("B1", 48, 128, 0, [2, 1]),
    ("B1", 40, 768, 0, [1]),  # 120 KB: one image fits, two do not
    ("B2", 48, 256, 130, [2, 1]),
    ("B2", 48, 256, 3000, [1]),  # two stagings of 3000 objects do not fit
    ("B6a", 64, 128, 0, [1]),  # flagship_v3: two 32 KB halves, one stage
    ("B6a", 64, 256, 0, [1]),  # two 64 KB halves, one stage
])
def test_stages_follow_the_shapes(kind, HP, WPC, N, stages):
    S = 6 if kind == "B2" else 3
    plans = tp.candidate_plans(kind, HP, WPC, 24, 3, 121, S, 256, N=N)
    assert [p.stages for p in plans] == stages
    assert all(p.warps == tp.WARPS and p.smem_bytes <= tp.MAX_SMEM for p in plans)
    if stages == [1] and 2 in tp.STAGE_COUNTS[kind]:
        assert tp.smem_bytes(kind, 2, 1, HP, WPC, 256, 24, 3, S, N) > tp.MAX_SMEM


@pytest.mark.parametrize("kind,HP,WPC,S,G,out_w,stages,kept", [
    ("B5", 48, 256, 6, 5, 512, [2, 1], 1),  # general_lp: one or two 48 KB images
    ("B5", 40, 768, 6, 5, 512, [1], 1),  # 120 KB: one image fits (one block per SM), two do not
    ("B5", 144, 512, 6, 5, 512, [0], 0),  # 288 KB: read from device memory
    ("B5", 48, 256, 6, 5, 133, [2, 1], 1),  # rows of 133 words, stored by the warp
    ("B6b", 64, 256, 4, 3, 384, [0], 0),  # arena_mood_v3
    ("B6b", 16, 128, 4, 3, 256, [0], 0),  # small halves: still read from device memory
    ("B3", 144, 512, 3, 3, 256, [0], 0),  # arena_128
    ("B3", 48, 128, 3, 3, 256, [0], 0),  # an image that would stage: still read from device memory
    ("B3", 144, 512, 4, 3, 256, [0], 0),  # 16 rounds: 12 in registers, 4 in shared memory
    ("B3", 144, 512, 6, 3, 256, [0], 0),  # 23 rounds: 12 in registers, 11 in shared memory
])
def test_per_env_mode_follows_the_shapes(kind, HP, WPC, S, G, out_w, stages, kept):
    A, K = 24, 121
    plans = tp.candidate_plans(kind, HP, WPC, A, G, K, S, out_w)
    assert [p.stages for p in plans] == stages
    rows = 12 * 2 * ((out_w + 3) // 4 * 4) * 4
    for p in plans:
        assert p.mode == ("device" if p.stages == 0 else "staged")
        assert p.warps == tp.WARPS and p.rounds == tp.rounds_for(G, K, S, kind)
        assert p.smem_bytes <= tp.MAX_SMEM
        tables = p.stages * (HP * WPC * 4 + ((A * (2 + G) + 3) // 4 * 4) * 4)
        more = tp.plan_bytes(p.rounds, kind)
        assert more == (128 * (p.rounds - 12) if kind == "B3" and p.rounds > 12 else 0)
        assert p.smem_bytes == rows + more + (tp.BARRIER_BYTES + tables if p.stages else 0)
    assert tp.choose(plans, _smem_blocks_per_sm).stages == kept
    if kind in ("B3", "B6b"):  # no staged plan exists
        with pytest.raises(ValueError, match="device memory"):
            tp.smem_bytes(kind, 1, 12, HP, WPC, out_w, A, G, S)
        with pytest.raises(ValueError, match="device memory"):
            tp.check_holds(kind, [tp.TailPlan(plans[0].rounds, 1, 12, 1000)], HP, WPC, G, S, out_w)
    elif stages == [0]:  # the image cannot be staged
        assert tp.plan_for(kind, 1, HP, WPC, A, G, K, S, out_w) is None
    else:  # the device plan fits too, but staging is kept
        assert tp.plan_for(kind, 0, HP, WPC, A, G, K, S, out_w) is not None


@pytest.mark.parametrize("kind,HP,WPC,G,out_w,reason", [
    ("B5", 48, 256, 33, 512, "global words"),  # globals past the first round
    ("B6b", 64, 256, 40, 384, "global words"),
    ("B5", 2, 20000, 5, 512, "do not pack"),  # window row offsets past 2^18 words
    ("B6b", 4, 40000, 3, 384, "do not pack"),
    ("B5", 48, 256, 5, 30000, "shared memory"),  # one warp's rows do not fit a block
    ("B6b", 64, 256, 3, 382, "multiple of 4"),  # v2 rows are bulk-stored whole
    ("B3", 144, 512, 33, 256, "global words"),
    ("B3", 2, 20000, 3, 256, "do not pack"),
    ("B3", 144, 512, 3, 250, "multiple of 4"),
    ("B1", 48, 128, 33, 256, "global words"),
    ("B2", 48, 256, 3, 250, "multiple of 4"),
    ("B6a", 64, 128, 40, 256, "global words"),
    ("B6a", 64, 128, 3, 254, "multiple of 4"),
])
def test_plans_that_cannot_hold_the_shapes_raise(kind, HP, WPC, G, out_w, reason):
    with pytest.raises(ValueError, match=reason):
        tp.candidate_plans(kind, HP, WPC, 24, G, 121, 1, out_w)


def test_staged_plan_refuses_an_image_of_partial_16_byte_units():
    staged = tp.TailPlan(4, 1, 4, 10000)
    tp.check_holds("B5", [tp.TailPlan(4, 0, 4, 10000)], 3, 5, 3, 1, 133)  # device mode reads any image
    with pytest.raises(ValueError, match="16-byte"):
        tp.check_holds("B5", [staged], 3, 5, 3, 1, 133)
    assert [p.stages for p in tp.candidate_plans("B5", 3, 5, 24, 3, 1, 1, 256)] == [0]


def test_choose_keeps_most_resident_warps():
    plans = [tp.TailPlan(12, 2, 12, 75776), tp.TailPlan(12, 1, 12, 50240)]
    assert tp.choose(plans, {plans[0]: 3, plans[1]: 3}.get).stages == 2  # a tie keeps more stages
    assert tp.choose(plans, {plans[0]: 1, plans[1]: 2}.get).stages == 1
    assert _smem_blocks_per_sm(plans[0]) == 3 and _smem_blocks_per_sm(plans[1]) == 4


def test_fewer_warps_where_rows_do_not_fit():
    """An image of 56,000 words leaves 7,488 bytes beside the mbarriers and
    one env's agent tables: one stage, with as many warps' row buffers of
    256 words as fit (3)."""
    (plan,) = tp.candidate_plans("B1", 56, 1000, 24, 3, 121, 3, 256)
    assert plan.stages == 1 and plan.warps == 3
    assert plan.smem_bytes <= tp.MAX_SMEM < tp.smem_bytes("B1", 1, 4, 56, 1000, 256, 24, 3, 3)
    with pytest.raises(ValueError):
        tp.candidate_plans("B1", 58, 1000, 24, 3, 121, 3, 256)


def test_rounds_and_grid():
    # Buckets up to 32 rounds; past them the rounds needed, all but 12 of
    # them in shared memory (32 entries of 4 bytes each).
    assert [tp.rounds_for(3, 121, s) for s in (1, 3, 4, 6, 7, 9)] == [4, 12, 16, 24, 32, 35]
    # The fused route's largest count: 32 globals and 15 window rows of 128 lanes.
    assert tp.rounds_for(32, 15, 128) == 61
    assert [tp.plan_bytes(r) for r in (12, 32, 35, 61)] == [0, 0, 23 * 128, 49 * 128]
    # B3's register plans stop at 12 rounds: past them, the rounds needed.
    assert [tp.rounds_for(3, 121, s, "B3") for s in (1, 3, 4, 6, 7, 9)] == [4, 12, 16, 23, 27, 35]
    assert [tp.plan_bytes(r, "B3") for r in (12, 16, 23, 61)] == [0, 4 * 128, 11 * 128, 49 * 128]
    assert tp.persistent_grid(4096, 132, 3) == 396
    assert tp.persistent_grid(7, 132, 3) == 7
    assert tp.persistent_grid(1, 132, 1) == 1
    with pytest.raises(ValueError):
        tp.persistent_grid(4096, 132, 0)


def test_bulk_rows_need_whole_16_byte_units():
    """B1's and B2's plans, like every v2 kind's, refuse rows that are not
    whole 16-byte units and globals past the first round of candidates."""
    assert tp.candidate_plans("B1", 48, 128, 24, 3, 121, 3, 256)
    with pytest.raises(ValueError, match="multiple of 4"):
        tp.candidate_plans("B1", 48, 128, 24, 3, 121, 3, 250)
    with pytest.raises(ValueError, match="global words"):
        tp.candidate_plans("B2", 48, 256, 24, 33, 121, 3, 256, N=130)
    with pytest.raises(ValueError, match="multiple of 4"):
        tp.check_holds("B1", [tp.TailPlan(12, 1, 12, 1000)], 48, 128, 3, 3, 250)


def test_b6a_offsets_carry_the_half():
    """B6a's staged plan addresses the right half through the offset: an odd
    window row lies one half (HP rows of WPC words) on, in bytes; B6b's
    device plan picks the half by the row and counts words."""
    HP, WPC, S = 64, 128, 3
    lanes = 16 * S - 1
    assert tp.max_offset("B6a", 1, WPC, S, HP) == (HP * WPC + 7 * WPC + lanes) * 4
    assert tp.max_offset("B6b", 0, WPC, S, HP) == 7 * WPC + lanes
    assert tp.max_offset("B1", 1, WPC, S) == (15 * WPC + lanes) * 4
    # Halves that fit one block never push the offset past the entry's field.
    (plan, *_) = tp.candidate_plans("B6a", 96, 256, 24, 3, 121, 3, 256)
    assert tp.refusal("B6a", plan, 96, 256, 3, 3, 256) is None


def test_largest_candidate_count_plans():
    """Every persistent kind plans 1952 candidates (32 globals, 15 window
    rows of 128 slots) at 61 rounds, in each of its modes, with the entries
    of the 49 rounds past its 12 register rounds in shared memory."""
    G, K, S = 32, 15, 128
    for kind, stages in (("B1", [2, 1]), ("B2", [2, 1]), ("B3", [0]), ("B4", [1]), ("B5", [2, 1]), ("B6a", [1]),
                         ("B6b", [0])):
        plans = tp.candidate_plans(kind, 32, 256, 24, G, K, S, 1024, N=60)
        assert [p.stages for p in plans] == stages and {p.rounds for p in plans} == {61}, kind
        for p in plans:
            assert p.smem_bytes == tp.smem_bytes(kind, p.stages, p.warps, 32, 256, 1024, 24, G, S, 60, 61)
            assert p.smem_bytes - tp.smem_bytes(kind, p.stages, p.warps, 32, 256, 1024, 24, G, S, 60) == 49 * 128
    assert tp.plan_for("B5", 0, 32, 256, 24, G, K, S, 1024).rounds == 61


def test_route_never_asks_the_plan(monkeypatch):
    """The route is a function of the shapes: it asks whether a kernel has a
    plan, never the card's occupancy or which plan the card would keep."""

    def refuse(*_args, **_kwargs):
        raise AssertionError("the route asked the card or the plan choice")

    monkeypatch.setattr(tp, "occupancy", refuse)
    monkeypatch.setattr(tp, "choose", refuse)
    for variant in ("flagship", "arena_128", "flagship_v3"):
        program, init = bench_run.build_pool(bench_run.make_cfg(variant), 1)
        bg = tobs.build_static_bg(program, init, "cpu")
        fn = tobs.make_obs_fn(program, bg, "cpu", obs_tail=bench_run.variant_options(variant)["obs_tail"])
        assert fn.route == BENCH[variant][0]
    # The same shapes route alike whatever the plans' stage counts would be.
    monkeypatch.setattr(tp, "STAGE_COUNTS", dict(tp.STAGE_COUNTS, B1=(1,), B2=(1,)))
    assert tobs.gate_route(True, True, True, False, 24, 3, 121, 3, 48, 128, 0, 256) == "B1"
    assert tobs.gate_route(True, True, True, True, 24, 3, 121, 3, 48, 128, 32, 256) == "B6a"


@pytest.mark.parametrize("G,out_w", [(5, 389), (5, 392), (53, 437), (64, 448), (64, 449)])
def test_b4_plans_any_globals_and_row_width(G, out_w):
    """B4 at the arena_lp image (48 x 128, K 121, S 3, 24 agents): B1's
    layout with v1 rows of any width, their buffers rounded up to 16 bytes,
    at 5 globals and at 53 and 64 (value observations), which take rounds
    of their own ahead of a plan of the window's 363 candidates alone (12
    rounds). B5 still refuses more than 32 globals."""
    HP, WPC, A, K, S = 48, 128, 24, 121, 3
    plans = tp.candidate_plans("B4", HP, WPC, A, G, K, S, out_w)
    assert [p.stages for p in plans] == [1]
    rounds = tp.rounds_for(G, K, S, "B4")
    assert rounds == 12 and 32 * rounds >= (G if G <= 32 else 0) + K * S
    assert tp.rounds_for(G, K, S) == {5: 12, 53: 16, 64: 16}[G]  # the other kinds' plans hold the globals too
    rows = 12 * 2 * ((out_w + 3) // 4 * 4) * 4
    for p in plans:
        assert p.warps == tp.WARPS and p.rounds == rounds
        tables = ((A * (4 + S + G) + 3) // 4 * 4) * 4
        assert p.smem_bytes == tp.BARRIER_BYTES + p.stages * (HP * WPC * 4 + tables) + rows
        assert p.smem_bytes == tp.smem_bytes("B1", p.stages, p.warps, HP, WPC, out_w, A, G, S)
        assert tp.refusal("B4", p, HP, WPC, G, S, out_w) is None
    if G > 32:
        with pytest.raises(ValueError, match="global words"):
            tp.candidate_plans("B5", HP, 256, A, G, K, S, out_w)
        with pytest.raises(ValueError, match="global words"):
            tp.candidate_plans("B1", HP, WPC, A, G, K, S, 448)
