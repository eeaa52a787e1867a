"""The launch plan of the persistent tails B1 and B2
(engine/kernels/tail_plan.py), a function of the shapes, at the bench
shapes and at the edges it branches on.

At full bench size (24 agents, 25x25 maps; arena_128 on 128x128 maps) the
obs function is built on the CPU and its route and tail shapes read: the
route stays B1/B2/B1/B3 for flagship/general/combat/arena_128. Each B1 or
B2 candidate plan fits one block's shared memory; the plan kept is the one
that leaves the most warps resident per SM (here counted from shared memory
alone; the wrapper asks the card, which also counts registers). Images or object tables that fit one stage but not two
run with one; images that leave no room for the row buffers of WARPS warps
run with fewer warps. The persistent grid holds every resident block and no
more blocks than envs. The wrappers refuse rows that are not whole 16-byte
units.
"""

import pytest

from mettagrid_tpu_torch.engine import obs as tobs
from mettagrid_tpu_torch.engine.kernels import tail_plan as tp
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import check_bulk_rows
from mettagrid_tpu_torch.tools import bench_run

def _smem_blocks_per_sm(plan):
    """Blocks per SM that shared memory alone allows: an H100 SM has 228 KB,
    1 KB of which each block reserves."""
    return 233472 // (plan.smem_bytes + 1024)


# variant -> (route, rounds, out_w, stages kept by the shared-memory count)
BENCH = {
    "flagship": ("B1", 12, 256, 1),
    "general": ("B2", 24, 512, 2),
    "combat": ("B1", 32, 384, 1),
    "arena_128": ("B3", 12, 256, None),
}


@pytest.mark.parametrize("variant", sorted(BENCH))
def test_bench_shapes_plan(variant):
    route, rounds, out_w, stages = BENCH[variant]
    program, init = bench_run.build_pool(bench_run.make_cfg(variant), 1)
    bg = tobs.build_static_bg(program, init, "cpu") if tobs.static_background_ok(program) else None
    fn = tobs.make_obs_fn(program, bg, "cpu")
    assert fn.route == route
    sh = fn.tail_shapes
    fits = tobs.staged_smem_bytes(sh["HP"], sh["WPC"], sh["K"], sh["S"]) <= tobs.MAX_SMEM
    assert fits == (route != "B3")
    assert fn.out_w == out_w
    if route == "B3":
        return
    N = init.obj_type.shape[1]
    A, G, S = program.num_agents, sh["G"], sh["S"]
    plans = tp.candidate_plans(route, A=A, out_w=fn.out_w, N=N, **sh)
    assert [p.stages for p in plans] == list(range(tp.STAGES, 0, -1))
    for p in plans:
        assert p.rounds == rounds == tp.rounds_for(G, sh["K"], S)
        assert 32 * p.rounds >= G + sh["K"] * S
        assert p.warps == min(tp.WARPS, A)
        assert p.smem_bytes == tp.smem_bytes(route, p.stages, p.warps, sh["HP"], sh["WPC"], fn.out_w, A, G, S, N)
        assert p.smem_bytes <= tp.MAX_SMEM
    assert tp.choose(plans, _smem_blocks_per_sm).stages == stages


@pytest.mark.parametrize("kind,HP,WPC,N,stages", [
    ("B1", 48, 128, 0, [2, 1]),
    ("B1", 40, 768, 0, [1]),  # 120 KB: one image fits, two do not
    ("B2", 48, 256, 130, [2, 1]),
    ("B2", 48, 256, 3000, [1]),  # two stagings of 3000 objects do not fit
])
def test_stages_follow_the_shapes(kind, HP, WPC, N, stages):
    S = 3 if kind == "B1" else 6
    plans = tp.candidate_plans(kind, HP, WPC, 24, 3, 121, S, 256, N=N)
    assert [p.stages for p in plans] == stages
    assert all(p.warps == tp.WARPS and p.smem_bytes <= tp.MAX_SMEM for p in plans)
    if stages == [1]:
        assert tp.smem_bytes(kind, 2, 1, HP, WPC, 256, 24, 3, S, N) > tp.MAX_SMEM


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
    assert [tp.rounds_for(3, 121, s) for s in (1, 3, 4, 6, 7)] == [4, 12, 16, 24, 32]
    with pytest.raises(ValueError):
        tp.rounds_for(3, 225, 5)
    assert tp.persistent_grid(4096, 132, 3) == 396
    assert tp.persistent_grid(7, 132, 3) == 7
    assert tp.persistent_grid(1, 132, 1) == 1
    with pytest.raises(ValueError):
        tp.persistent_grid(4096, 132, 0)


def test_bulk_rows_need_whole_16_byte_units():
    check_bulk_rows("B1", 256, 3)
    with pytest.raises(ValueError, match="multiple of 4"):
        check_bulk_rows("B1", 250, 3)
    with pytest.raises(ValueError, match="global words"):
        check_bulk_rows("B2", 256, 33)
