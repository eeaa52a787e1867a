"""The launch plan of kernel B7 (engine/kernels/window_slices.py), a
function of the shapes, at the bench shapes and at the edges it branches on.

At full bench size (24 agents, 25x25 maps) the territory and full_combat
variants route to the non-fused path; their window inputs are built on the
CPU and their shapes read: territory's (40 x 384 image words, Ch = 9) take
word entries stored four at a time, full_combat's (40 x 1024, Ch = 24)
16-byte entries. Entries are 16-byte units only where every cell and image
row is whole 16-byte units and the image is 16-byte aligned (Ch = 4, 24;
not Ch = 9 or 1, rows of 390 words or an unaligned image); word entries are
stored four at a time only where an env's output is whole 16-byte units
and a window has four words or more (not 23 agents of 121 one-word cells,
nor a window of three words). Every plan lists the narrower ones before it,
and the wrapper takes the widest. Tables too large for shared memory are
refused with the reason. Every plan runs one block of 32 warps per SM, no
more blocks than envs. On CPU tensors the wrapper takes the plain version
and counts no launch.
"""

import pytest
import torch

from mettagrid_tpu_torch.engine.kernels import tail_plan
from mettagrid_tpu_torch.engine.kernels import window_slices as b7
from mettagrid_tpu_torch.tools.bench_run import BenchRun

K = 121  # an 11x11 window
A = 24

# variant -> (image rows, row words, Ch, (words per entry, words per store) kept)
BENCH = {
    "territory": (40, 384, 9, (1, 4)),
    "full_combat": (40, 1024, 24, (4, 4)),
}


def _shapes(plans):
    return [(p.vec, p.store) for p in plans]


@pytest.mark.parametrize("variant", sorted(BENCH))
def test_bench_shapes_plan(variant):
    HP, WPC, Ch, kept = BENCH[variant]
    bench = BenchRun(variant, seed=0, envs=2, device="cpu", pool=1)
    assert bench.step.obs_fn.route == "nonfused"
    args = bench.step.obs_fn.window_inputs(bench.reset(0)[0])
    assert tuple(args["img"].shape[1:]) == (HP, WPC) and args["Ch"] == Ch
    assert tuple(args["row0"].shape[1:]) == (A,) and args["geom"].shape[0] == K
    plan = b7.window_plan(WPC, A, K, Ch)
    assert (plan.vec, plan.store) == kept
    assert plan.warps == b7.WARPS == 32
    assert plan.smem_bytes == K * Ch // plan.vec * 8 <= b7.MAX_SMEM
    assert b7.window_plans(WPC, A, K, Ch)[-1] == plan


def test_grid_is_one_block_per_sm():
    """One block per SM, however many the card would allow, and no more
    blocks than envs."""
    assert b7.BLOCKS_PER_SM == 1
    assert tail_plan.persistent_grid(4096, 132, min(4, b7.BLOCKS_PER_SM)) == 132
    assert tail_plan.persistent_grid(7, 132, min(2, b7.BLOCKS_PER_SM)) == 7
    with pytest.raises(ValueError):
        tail_plan.persistent_grid(4096, 132, min(0, b7.BLOCKS_PER_SM))


@pytest.mark.parametrize("WPC, agents, cells, Ch, plans", [
    (896, 24, K, 24, [(1, 1), (1, 4), (4, 4)]),  # full_combat's cells at the reference's image width
    (384, 24, K, 4, [(1, 1), (1, 4), (4, 4)]),  # Ch = 4: 16-byte entries
    (384, 24, K, 9, [(1, 1), (1, 4)]),  # Ch = 9: word entries
    (128, 24, K, 1, [(1, 1), (1, 4)]),  # Ch = 1
    (128, 23, K, 1, [(1, 1)]),  # an env output of 2783 words: word stores
    (390, 24, K, 24, [(1, 1), (1, 4)]),  # rows of partial 16-byte units: word entries
    (128, 4, 3, 1, [(1, 1)]),  # a window of three words: no store of four within it
])
def test_entry_and_store_widths_follow_the_shapes(WPC, agents, cells, Ch, plans):
    got = b7.window_plans(WPC, agents, cells, Ch)
    assert _shapes(got) == plans
    assert (b7.window_plan(WPC, agents, cells, Ch).vec, b7.window_plan(WPC, agents, cells, Ch).store) == plans[-1]


def test_unaligned_image_takes_word_entries():
    assert _shapes(b7.window_plans(384, A, K, 24, aligned=False)) == [(1, 1), (1, 4)]


def test_tables_too_large_are_refused():
    with pytest.raises(ValueError, match=r"table of 121 cells x 301 channels \(291368 bytes\) does not fit"):
        b7.window_plans(384 * 8, A, K, 301)
    # Where word entries' table does not fit, 16-byte entries' (a quarter) may.
    assert _shapes(b7.window_plans(384 * 8, A, K, 300)) == [(4, 4)]
    assert b7.window_plans(384 * 8, A, K, 300)[0].smem_bytes == K * 300 // 4 * 8
    with pytest.raises(ValueError, match="does not fit shared memory"):
        b7.window_plans(384, A, K, 9, max_smem=4096)


def test_wrapper_takes_plain_version_on_cpu():
    """CPU tensors: the plain version, no launch; a plan that does not hold
    the shapes is refused before anything is built."""
    g = torch.Generator().manual_seed(0)
    E, agents, HP, WPC, Ch = 3, 4, 16, 64, 4
    img = torch.randint(-1000, 1000, (E, HP, WPC), generator=g, dtype=torch.int32)
    row0 = torch.randint(-2, HP, (E, agents), generator=g, dtype=torch.int32)
    lane0 = torch.randint(-8, WPC, (E, agents), generator=g, dtype=torch.int32)
    geom = torch.tensor([[u, v, (u << 4) | v] for u in range(3) for v in range(3)], dtype=torch.int32)
    before = b7.window_slices.launches
    got = b7.window_slices(img, row0, lane0, geom, Ch)
    assert b7.window_slices.launches == before
    assert torch.equal(got, b7.window_slices_ref(img, row0, lane0, geom, Ch))
    with pytest.raises(ValueError, match="does not hold the shapes"):
        b7.launch_plan(b7.WindowPlan(4, 4, b7.WARPS, 1), img, row0, lane0, geom, Ch)
