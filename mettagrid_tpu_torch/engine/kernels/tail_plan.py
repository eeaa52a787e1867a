"""The launch plan of the persistent tails B1 (obs_tail_static_v2) and B2
(obs_tail_dynobj_v2), as functions of the shapes.

Both kernels (engine/csrc/obs_tail_bulk.cuh) run persistent blocks of
``warps`` warps that walk the envs; each warp stores its rows by bulk copy
from two row buffers of out_w words in shared memory, and each lane holds
``rounds`` candidate entries in registers (a compiled bucket at or above
ceil((G + K*S) / 32)). With ``stages`` > 1 a block stages the env
``stages`` - 1 envs ahead while it runs the current one: B1 its image (bulk
copy) and agent tables (cp.async), B2 its object and agent tables; with one
stage B1 stages each env just before its tail and B2 reads the tables from
device memory. B1 keeps 128 bytes of mbarriers ahead of its images. The
plan takes the most stages and warps that fit one block's shared memory,
then keeps the candidate that leaves the most warps resident per SM; the
obs route (obs.tail_route) never depends on it: it gates on one image and
the candidate tables (staged_smem_bytes).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

# Shared memory one block may use on Hopper (bytes).
MAX_SMEM = 232448
# Candidate rounds per lane the kernels are compiled for.
ROUND_BUCKETS = (4, 8, 12, 16, 24, 32)
# Warps per block: one per agent up to this many (the kernels are compiled
# for at most 16).
WARPS = 12
MAX_WARPS = 16
# Pipeline stages the kernels are compiled for: one or two (a deeper
# pipeline did not pay on the bench shapes).
STAGES = 2
# B1's mbarriers, ahead of its image buffers.
BARRIER_BYTES = 128


class TailPlan(NamedTuple):
    rounds: int  # candidate entries per lane (a compiled bucket)
    stages: int  # envs staged at once (1: each env staged just before its tail)
    warps: int  # warps per block
    smem_bytes: int  # dynamic shared memory per block


def rounds_for(G: int, K: int, S: int) -> int:
    """The smallest compiled bucket of rounds that holds the G globals and
    the K*S window candidates, 32 per round."""
    need = -(-(G + K * S) // 32)
    for r in ROUND_BUCKETS:
        if r >= need:
            return r
    raise ValueError(f"{G + K * S} candidates need {need} rounds of 32 (at most {ROUND_BUCKETS[-1]})")


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(kind: str, stages: int, warps: int, HP: int, WPC: int, out_w: int, A: int, G: int, S: int,
               N: int = 0) -> int:
    """Dynamic shared memory of one block of kernel ``kind`` ("B1" or "B2"):
    B1's mbarriers, and per stage an image and an env's agent tables (row0,
    lane0, rext, lext, words, gplus), or B2's image and, with more than one
    stage, per stage an env's tables (rext, lext, words, row0, lane0,
    gplus); then both kernels' row buffers, two of out_w words per warp."""
    img = HP * WPC * 4
    rows = warps * 2 * out_w * 4
    if kind == "B1":
        return BARRIER_BYTES + stages * (img + _pad4(A * (4 + S + G)) * 4) + rows
    if kind == "B2":
        return img + rows + (stages * _pad4(N * (2 + S) + A * (2 + G)) * 4 if stages > 1 else 0)
    raise ValueError(f"unknown tail kind {kind!r}")


def candidate_plans(kind: str, HP: int, WPC: int, A: int, G: int, K: int, S: int, out_w: int, N: int = 0,
                    max_smem: int = None) -> list:
    """For each stage count from STAGES down to 1, the plan with the most
    warps (min(A, WARPS) at most) whose shared memory fits ``max_smem``
    (MAX_SMEM by default), where one does."""
    max_smem = MAX_SMEM if max_smem is None else max_smem
    rounds = rounds_for(G, K, S)
    plans = []
    for stages in range(STAGES, 0, -1):
        for w in range(max(1, min(A, WARPS, MAX_WARPS)), 0, -1):
            need = smem_bytes(kind, stages, w, HP, WPC, out_w, A, G, S, N)
            if need <= max_smem:
                plans.append(TailPlan(rounds, stages, w, need))
                break
    if not plans:
        raise ValueError(f"{kind}: one image of {HP}x{WPC} words and one warp's rows of {out_w} words need "
                         f"{smem_bytes(kind, 1, 1, HP, WPC, out_w, A, G, S, N)} bytes of shared memory (> {max_smem})")
    return plans


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


def occupancy(lib, name: str, plan: TailPlan, device) -> tuple:
    """(blocks per SM, registers per thread, SMs) of kernel ``name``'s
    instance for ``plan`` on ``device`` (a CUDA device), from the library's
    ``<name>_occupancy``; asked once per plan and device."""
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
            err = fn(plan.rounds, plan.stages, plan.warps, plan.smem_bytes, res)
        if err != 0:
            raise RuntimeError(f"{name}: occupancy query failed with cudaError_t {err}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        got = _OCCUPANCY[key] = (res[0], res[1], sms)
    return got
