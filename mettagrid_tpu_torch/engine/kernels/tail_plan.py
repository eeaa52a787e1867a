"""The launch plan of the persistent tails B1 (obs_tail_static_v2), B2
(obs_tail_dynobj_v2), B3 (obs_tail_dyn_v2), B4 (obs_tail_static_v1), B5
(obs_tail_v1), B6a (obs_tail_static_v3) and B6b (obs_tail_dyn_v3), as
functions of the shapes.

The kernels (engine/csrc/obs_tail_bulk.cuh) run persistent blocks of
``warps`` warps that walk the envs; each warp stores its rows by bulk copy
from two row buffers of out_w words (rounded up to 16 bytes) in shared
memory, and each lane holds ``rounds`` candidate entries in registers (a
compiled bucket at or above ceil((G + K*S) / 32)); past its kind's last
bucket (LAST_BUCKET) the plan keeps MORE_REGISTER_ROUNDS rounds in
registers and the rest, 32 entries each, at the end of the block's shared
memory (plan_bytes). With ``stages`` > 1 a block stages the env ``stages``
- 1 envs ahead while it runs the current one: B1 its pooled image (bulk
copy) and agent tables (cp.async), B2 its object and agent tables, B5 its
per-env image and agent tables; with one stage B1, B4 (B1's kernel in the
v1 words), B5 and B6a (its two paired halves by two bulk copies) stage each
env just before its tail and B2 reads the tables from device memory. B1,
B4, B5 and B6a keep 128 bytes of mbarriers ahead of their images.
``stages`` = 0 is the device mode of B3, B5 and B6b: the image (B6b: its
paired halves) is read from device memory, and shared memory holds the row
buffers alone. B3 and B6b have the device mode alone.

For each kind, candidate_plans gives the plan with the most warps that fits
one block's shared memory at each of its stage counts (STAGE_COUNTS), less
the plans that cannot hold the shapes (refusal), and for B5 the device plan
only where no staged plan is left: staging beat the device mode on the card
wherever it fit, at one block per SM too (PERF.md). choose keeps the
candidate that leaves the most warps resident per SM (the wrappers ask the
card), the one with the most stages on a tie. The obs route
(obs.gate_route) asks only whether a kind has a plan for the shapes
(``holds``), never which one the card would pick.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

# Shared memory one block may use on Hopper (bytes).
MAX_SMEM = 232448
# Candidate rounds per lane the kernels keep in registers, as compiled
# buckets. Past a kind's last bucket, one instance per kernel and stage count
# keeps MORE_REGISTER_ROUNDS rounds in registers and the entries of the
# further rounds in shared memory: register plans of 48 or 64 rounds spilled
# even at 255 registers, and 32 register rounds beside the shared ones
# spilled at 64 and 128 (ptxas on the card, PERF.md). The fused route admits
# 15 window rows of 128 lanes at most (a location byte packs window rows
# 0-14), and every kind but B4 at most 32 globals: 1952 candidates, 61
# rounds. B4 runs more than 32 globals in rounds of their own, ahead of a
# plan of the window candidates alone (rounds_for).
ROUND_BUCKETS = (4, 8, 12, 16, 24, 32)
MORE_REGISTER_ROUNDS = 12
# The last register bucket of the kinds that stop before ROUND_BUCKETS[-1]:
# B3's register plans of 16-32 rounds spilled, and past 12 rounds it takes
# the instance with entries in shared memory (PERF.md).
LAST_BUCKET = {"B3": 12}
# Warps per block: one per agent up to this many (the kernels are compiled
# for at most 16).
WARPS = 12
MAX_WARPS = 16
# Stage counts each kernel is compiled for, most first: one or two (a
# deeper pipeline did not pay on the bench shapes; B6a one, since its two
# halves per stage left two stages slower wherever they fit, and B4 one,
# since its rows of GP + 128 k words left two stages slower at every warp
# count measured, PERF.md), and 0 for the device mode of B3, B5 and B6b.
STAGE_COUNTS = {"B1": (2, 1), "B2": (2, 1), "B3": (0,), "B4": (1,), "B5": (2, 1, 0), "B6a": (1,), "B6b": (0,)}
# The kinds that read their image from device memory only.
DEVICE_ONLY = ("B3", "B6b")
# The mbarriers of B1, B4, B5 and B6a, ahead of their image buffers.
BARRIER_BYTES = 128
# A plan entry's offset field: offsets below 2^18, in bytes for an image in
# shared memory and in words for one in device memory (obs_tail_bulk.cuh
# Plan).
OFFSET_LIMIT = 1 << 18


class TailPlan(NamedTuple):
    rounds: int  # candidate entries per lane (a compiled bucket)
    stages: int  # envs staged at once (1: each env staged just before its tail; 0: device mode)
    warps: int  # warps per block
    smem_bytes: int  # dynamic shared memory per block

    @property
    def mode(self) -> str:
        """"staged" (the image, or B2's tables, in shared memory) or
        "device" (B3's, B5's or B6b's image read from device memory)."""
        return "device" if self.stages == 0 else "staged"


def _last_bucket(kind: str) -> int:
    return LAST_BUCKET.get(kind, ROUND_BUCKETS[-1])


def rounds_for(G: int, K: int, S: int, kind: str = "") -> int:
    """The rounds of 32 candidates that hold the G globals and the K*S
    window candidates in kernel ``kind``'s plan: the smallest compiled
    bucket that does, or, past the kind's last, the rounds needed
    (plan_bytes). B4's plan holds the window candidates alone where G > 32
    (its globals then take ceil(G / 32) rounds of their own ahead of them)."""
    need = -(-(K * S if kind == "B4" and G > 32 else G + K * S) // 32)
    return next((r for r in ROUND_BUCKETS if need <= r <= _last_bucket(kind)), need)


def plan_bytes(rounds: int, kind: str = "") -> int:
    """Shared memory of a plan's entries past its register rounds: none up
    to the kind's last bucket, else 32 entries of 4 bytes per round past
    MORE_REGISTER_ROUNDS."""
    return (rounds - MORE_REGISTER_ROUNDS) * 32 * 4 if rounds > _last_bucket(kind) else 0


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(kind: str, stages: int, warps: int, HP: int, WPC: int, out_w: int, A: int, G: int, S: int,
               N: int = 0, rounds: int = 0) -> int:
    """Dynamic shared memory of one block of kernel ``kind``: B1's and
    B4's mbarriers, and per stage an image and an env's agent tables (row0,
    lane0, rext, lext, words, globals); B6a the same with two paired halves
    of HP rows each in place of the image; B2's image and, with more than
    one stage, per stage an env's tables (rext, lext, words, row0, lane0,
    gplus); staged B5 the mbarriers and per stage the env's image and agent
    tables (row0, lane0, globals); then every kernel's row buffers, two of
    out_w words (rounded up to 16 bytes) per warp, which are all that B3, B5
    and B6b hold in device mode (stages = 0); and last, for a plan of more
    ``rounds`` than the kind's last bucket, its entries in shared memory
    (plan_bytes)."""
    img = HP * WPC * 4
    rows = warps * 2 * _pad4(out_w) * 4 + plan_bytes(rounds, kind)  # with the plan's entries past the registers
    if kind in ("B1", "B4", "B6a"):
        halves = 2 if kind == "B6a" else 1
        return BARRIER_BYTES + stages * (halves * img + _pad4(A * (4 + S + G)) * 4) + rows
    if kind == "B2":
        return img + rows + (stages * _pad4(N * (2 + S) + A * (2 + G)) * 4 if stages > 1 else 0)
    if kind == "B5":
        return BARRIER_BYTES + stages * (img + _pad4(A * (2 + G)) * 4) + rows if stages else rows
    if kind in DEVICE_ONLY:
        if stages:
            raise ValueError(f"{kind} reads its image from device memory (stages 0)")
        return rows
    raise ValueError(f"unknown tail kind {kind!r}")


def max_offset(kind: str, stages: int, WPC: int, S: int, HP: int = 0) -> int:
    """The largest plan offset any window of the location byte's span (rows
    and cells 0-15) can take in kind's image, in the unit of the mode
    (bytes staged, words in device memory): a flat image's row u lies u*WPC
    words from the corner, a paired half's u >> 1 rows, and in B6a's staged
    halves (HP rows each, back to back) an odd row's half lies HP*WPC words
    on."""
    lanes = 16 * S - 1
    paired = kind in ("B6a", "B6b")
    words = (7 if paired else 15) * WPC + lanes + (HP * WPC if kind == "B6a" else 0)
    return words * 4 if stages else words


def refusal(kind: str, plan: "TailPlan", HP: int, WPC: int, G: int, S: int, out_w: int):
    """Why ``plan`` of kernel ``kind`` cannot hold the shapes, or None where
    it can: a staged plan of a kind that reads device memory only (B3,
    B6b), more than 32 globals (every global lies in the first round of
    candidates; B4 alone gives globals past 32 rounds of their own), v2
    rows that are not whole 16-byte units (they are bulk-stored; B4's and
    B5's v1 rows of any width are not), window offsets that do
    not pack in a plan entry, or a staged image (B6a: each half) that is not
    whole 16-byte units. For B6a and B6b, HP is the rows of each paired
    half."""
    if kind in DEVICE_ONLY and plan.stages:
        return f"{kind}: reads its image from device memory (stages 0, not {plan.stages})"
    if G > 32 and kind != "B4":
        return f"{kind}: {G} global words (at most 32)"
    if kind not in ("B4", "B5") and out_w % 4:
        return f"{kind}: out_w = {out_w} is not a multiple of 4 (rows are stored in 16-byte units)"
    if max_offset(kind, plan.stages, WPC, S, HP) >= OFFSET_LIMIT:
        unit = "bytes" if plan.stages else "words"
        return (f"{kind}: window offsets of up to {max_offset(kind, plan.stages, WPC, S, HP)} {unit} "
                f"({plan.mode} mode, WPC {WPC}) do not pack below {OFFSET_LIMIT}")
    if plan.stages and (HP * WPC) % 4:
        return f"{kind}: a staged image of {HP}x{WPC} words is not whole 16-byte units"
    return None


def check_holds(kind: str, plans, HP: int, WPC: int, G: int, S: int, out_w: int) -> None:
    """Raises, with its reason, where one of kind's ``plans`` cannot hold
    the shapes (refusal)."""
    for p in plans:
        why = refusal(kind, p, HP, WPC, G, S, out_w)
        if why:
            raise ValueError(why)


def plan_for(kind: str, stages: int, HP: int, WPC: int, A: int, G: int, K: int, S: int, out_w: int, N: int = 0,
             max_smem: int = None):
    """The plan of kernel ``kind`` with ``stages`` stages (0: device mode) and
    the most warps (min(A, WARPS) at most) whose shared memory fits
    ``max_smem`` (MAX_SMEM by default), or None where none does."""
    max_smem = MAX_SMEM if max_smem is None else max_smem
    rounds = rounds_for(G, K, S, kind)
    for w in range(max(1, min(A, WARPS, MAX_WARPS)), 0, -1):
        need = smem_bytes(kind, stages, w, HP, WPC, out_w, A, G, S, N, rounds)
        if need <= max_smem:
            return TailPlan(rounds, stages, w, need)
    return None


def candidate_plans(kind: str, HP: int, WPC: int, A: int, G: int, K: int, S: int, out_w: int, N: int = 0,
                    max_smem: int = None) -> list:
    """For each of kind's stage counts (STAGE_COUNTS), the plan with the
    most warps that fits (plan_for), where one does and where it can hold
    the shapes (refusal); B5's device plan only where no staged plan is
    left. Raises with the reasons where no plan is left. For B6a and B6b,
    HP is the rows of each paired half."""
    max_smem = MAX_SMEM if max_smem is None else max_smem
    plans = [p for p in (plan_for(kind, st, HP, WPC, A, G, K, S, out_w, N, max_smem) for st in STAGE_COUNTS[kind])
             if p]
    if not plans:
        least = STAGE_COUNTS[kind][-1]
        need = smem_bytes(kind, least, 1, HP, WPC, out_w, A, G, S, N, rounds_for(G, K, S, kind))
        raise ValueError(f"{kind}: {least} stage(s) of a {HP}x{WPC} image and one warp's rows of {out_w} words need "
                         f"{need} bytes of shared memory (> {max_smem})")
    why = {p: refusal(kind, p, HP, WPC, G, S, out_w) for p in plans}
    if all(why.values()):
        raise ValueError("; ".join(dict.fromkeys(why.values())))
    plans = [p for p in plans if not why[p]]
    if any(p.stages for p in plans):
        plans = [p for p in plans if p.stages]
    return plans


def holds(kind: str, HP: int, WPC: int, A: int, G: int, K: int, S: int, out_w: int, N: int = 0,
          max_smem: int = None) -> bool:
    """Whether kernel ``kind`` has a plan for the shapes (candidate_plans
    raises nothing): a function of the shapes alone, whatever plan the card
    would then pick."""
    try:
        candidate_plans(kind, HP, WPC, A, G, K, S, out_w, N, max_smem)
    except ValueError:
        return False
    return True


def choose(plans: list, blocks_per_sm: Callable) -> TailPlan:
    """The plan that leaves the most warps resident per SM (blocks per SM,
    from ``blocks_per_sm(plan)``, times warps), the first such one (the most
    stages) on a tie."""
    return max(plans, key=lambda p: (blocks_per_sm(p) * p.warps, p.stages))


def persistent_grid(E: int, sm_count: int, blocks_per_sm: int) -> int:
    """Blocks of a persistent launch: every block resident at once, and no
    more blocks than envs."""
    if blocks_per_sm < 1:
        raise ValueError("the kernel does not fit one SM")
    return max(1, min(E, sm_count * blocks_per_sm))


_OCCUPANCY: dict = {}


def occupancy(lib, name: str, plan, device) -> tuple:
    """(blocks per SM, registers per thread, SMs) of kernel ``name``'s
    instance for ``plan`` (a TailPlan, or B7's WindowPlan, whose words per
    entry and per store take the place of the rounds and stages) on
    ``device`` (a CUDA device), from the library's ``<name>_occupancy``;
    asked once per plan and device."""
    import ctypes

    import torch

    key = (name, plan, device)
    got = _OCCUPANCY.get(key)
    if got is None:
        fn = getattr(lib, f"{name}_occupancy")
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
        res = (ctypes.c_int * 2)()
        with torch.cuda.device(device):
            err = fn(plan[0], plan[1], plan.warps, plan.smem_bytes, res)
        if err != 0:
            raise RuntimeError(f"{name}: occupancy query failed with cudaError_t {err}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        got = _OCCUPANCY[key] = (res[0], res[1], sms)
    return got
