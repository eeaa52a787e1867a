"""Kernel B1: the fused observation tail for static-background configs.

Replaces the TPU kernel ``obs_tail_static_v2_pallas``
(mettagrid_tpu/engine/pallas_kernels.py:594). The CUDA source is
``engine/csrc/obs_tail_static_v2.cu``; its head says what bounds it and how
the design answers that.

``obs_tail_static_v2`` launches the kernel for CUDA tensors and takes the
plain PyTorch version ``obs_tail_static_v2_ref`` for CPU tensors. The launch
(persistent blocks, warps per block, envs staged ahead) is planned from the
shapes by ``tail_plan``. Both compute, per env e and agent a:

* the env image: ``static_imgp[map_idx[e]]`` (+1-encoded token words, 0 =
  empty) plus every agent's S words added at ``(rext, lext + s)``;
* the candidates: G global words ``gplus[e, a]``, then the image at
  ``(row0 + u_k, lane0 + v_k*S + s)`` for the K window cells of ``geom``
  (rows ``(u, v, loc)`` in Manhattan order) and s < S; cells outside the
  image read as empty;
* the valid candidates (> 0), front-compacted stably into
  ``out[e, a, :out_w]`` as ``loc | feat << 8 | val << 16`` words (0xFFFFFF for
  empty slots), and ``attempted[e, a]``, the number of valid candidates.

``wide`` selects the reference's wide packing (loc shifted by 14, 6-bit
feature mask) instead of the normal one (shift 15, 7-bit mask); the two agree
whenever every feature id is below 64.
"""

from __future__ import annotations

import ctypes

import torch

from mettagrid_tpu_torch.engine.kernels import build, count_launch, tail_plan
from mettagrid_tpu_torch.engine.kernels.tail_plan import MAX_SMEM  # noqa: F401 (the obs route's and B7's limit)
from mettagrid_tpu_torch.engine.program import GLOBAL_LOCATION

EMPTY_WORD = 0xFFFFFF


def _packing(wide: bool):
    return (14, 0x3F00) if wide else (15, 0x7F00)


def add_words(img, HP: int, WPC: int, rext, lext, words):
    """Adds to img int32[E, HP * WPC], IN PLACE, each entity m's S words at
    (rext[e, m], lext[e, m] + s); positions outside the image add nothing.
    Returns img."""
    E, M, S = words.shape
    s_ = torch.arange(S, dtype=torch.int32, device=img.device)
    r = rext[..., None].expand(E, M, S)
    lane = lext[..., None] + s_
    on = (r >= 0) & (r < HP) & (lane >= 0) & (lane < WPC)
    at = torch.where(on, r * WPC + lane, 0).reshape(E, M * S).long()
    return img.scatter_add_(1, at, torch.where(on, words, 0).reshape(E, M * S))


def candidates(img, HP: int, WPC: int, row0, lane0, front, geom, S: int):
    """Each agent's candidate cells int32[E, A, F + K*S] over per-env images
    img int32[E, HP * WPC]: the F ``front`` words, then the image at
    (row0 + u_k, lane0 + v_k*S + s) in Manhattan order (cells outside the
    image read 0), and the location byte of each candidate (0xFE for the
    front words)."""
    E, A = row0.shape
    dev = row0.device
    i32 = torch.int32
    s_ = torch.arange(S, dtype=i32, device=dev)
    du = geom[:, 0].repeat_interleave(S)  # [KS] window row per candidate
    dl = (geom[:, 1][:, None] * S + s_[None, :]).reshape(-1)  # [KS] window lane
    rr = row0[..., None] + du
    ll = lane0[..., None] + dl
    inside = (rr >= 0) & (rr < HP) & (ll >= 0) & (ll < WPC)
    KS = du.shape[0]
    at = torch.where(inside, rr * WPC + ll, 0).reshape(E, A * KS).long()
    cand = torch.where(inside, img.gather(1, at).reshape(E, A, KS), 0)
    F = front.shape[2]
    loc = torch.cat([torch.full((F,), GLOBAL_LOCATION, dtype=i32, device=dev), geom[:, 2].repeat_interleave(S)])
    return torch.cat([front, cand], dim=-1), loc


def compact_ref(word, ok, width: int, fill: int):
    """The valid words of each row front-compacted stably into int32[E, A,
    width] (``fill`` elsewhere; ranks past width are dropped)."""
    E, A, _ = word.shape
    rank = ok.cumsum(dim=-1) - 1
    dest = torch.where(ok & (rank < width), rank, width)  # column width collects the rest
    out = torch.full((E, A, width + 1), fill, dtype=torch.int32, device=word.device)
    out.scatter_(2, dest, word)
    return out[..., :width].contiguous()


def v2_words_ref(cells, loc, out_w: int, wide: bool):
    """Candidate cells int32[E, A, C] with their location bytes, valid when
    > 0, front-compacted into packed v2 words, and the valid counts."""
    ok = cells > 0
    loc_sh, feat_mask = _packing(wide)
    packed = (cells - 1) | (loc << loc_sh)
    loc_field = (packed >> loc_sh) & 0xFF
    word = torch.where(
        loc_field == 0xFF, EMPTY_WORD, loc_field | (packed & feat_mask) | ((packed & 0xFF) << 16)
    )
    return compact_ref(word, ok, out_w, EMPTY_WORD), ok.sum(dim=-1, dtype=torch.int32)


def tail_ref(img, HP: int, WPC: int, row0, lane0, gplus, geom, S: int, out_w: int, wide: bool):
    """The v2 tail over per-env images img int32[E, HP * WPC]: each agent's
    G global words and window candidates, valid when > 0, front-compacted
    into packed words (kernels B1, B2 and B3 share it)."""
    return v2_words_ref(*candidates(img, HP, WPC, row0, lane0, gplus, geom, S), out_w, wide)


def obs_tail_static_v2_ref(static_imgp, map_idx, row0, lane0, rext, lext, words, gplus, geom, out_w: int, wide: bool = False):
    """Plain PyTorch version of the kernel (any device). Returns
    (words int32[E, A, out_w], attempted int32[E, A])."""
    _, HP, WPC = static_imgp.shape
    E = row0.shape[0]
    img = add_words(static_imgp[map_idx.long()].reshape(E, HP * WPC), HP, WPC, rext, lext, words)
    return tail_ref(img, HP, WPC, row0, lane0, gplus, geom, words.shape[2], out_w, wide)


def check_static_inputs(name, static_imgp, map_idx, row0, lane0, rext, lext, words, front, geom, out_w):
    """The checks the wrappers of B1, B4 and B6a share: one device, int32,
    contiguous, matching shapes, non-empty, an image that their staging
    loads (whole 16-byte rows, 16-byte aligned)."""
    dev = static_imgp.device
    named = dict(
        static_imgp=static_imgp, map_idx=map_idx, row0=row0, lane0=lane0, rext=rext,
        lext=lext, words=words, globals=front, geom=geom,
    )
    for arg, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, static_imgp on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if static_imgp.dim() != 3 or row0.dim() != 2 or words.dim() != 3 or front.dim() != 3 or geom.dim() != 2:
        raise ValueError(f"{name}: wrong ranks")
    P, HP, WPC = static_imgp.shape
    E, A = row0.shape
    S, G, K = words.shape[2], front.shape[2], geom.shape[0]
    for arg, t, shape in (
        ("map_idx", map_idx, (E,)), ("lane0", lane0, (E, A)), ("rext", rext, (E, A)),
        ("lext", lext, (E, A)), ("words", words, (E, A, S)), ("globals", front, (E, A, G)),
        ("geom", geom, (K, 3)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shape}")
    if P < 1 or E < 1 or A < 1 or S < 1 or out_w < 1:
        raise ValueError(f"{name}: empty pool, batch, agent set, slot set or output")
    if (HP * WPC) % 4 or static_imgp.data_ptr() % 16:
        raise ValueError(f"{name}: the image must be a whole number of 16-byte rows, 16-byte aligned")


_CHOSEN: dict = {}  # (kernel, plans, E, device) -> (plan, grid, blocks per SM, registers, SMs)
_PLANS: dict = {}  # B1's candidate plans by shapes


def launch(lib, name: str, plans, E: int, device, args) -> dict:
    """Launches kernel ``name`` of ``lib`` with the plan of ``plans``
    (tail_plan.candidate_plans) that leaves the most warps resident per SM
    on ``device``, on a persistent grid for E envs, after ``args``
    (pointers and shapes); raises on a launch error. Returns the launch's
    record: grid, warps, stages, mode, rounds, shared bytes, blocks per SM,
    registers and SMs. The choice is kept per kernel, plans, E and device,
    so a repeated launch (or its capture into a CUDA graph) only launches."""
    key = (name, tuple(plans), E, device)
    chosen = _CHOSEN.get(key)
    if chosen is None:
        occ = {p: tail_plan.occupancy(lib, name, p, device) for p in plans}
        plan = tail_plan.choose(plans, lambda p: occ[p][0])
        chosen = _CHOSEN[key] = (plan, tail_plan.persistent_grid(E, occ[plan][2], occ[plan][0]), *occ[plan])
    plan, grid, blocks_per_sm, regs, sms = chosen
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{name}_launch")(
            *args, plan.rounds, plan.stages, plan.warps, grid, plan.smem_bytes, stream
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    return dict(grid=grid, warps=plan.warps, stages=plan.stages, mode=plan.mode, rounds=plan.rounds,
                smem_bytes=plan.smem_bytes, blocks_per_sm=blocks_per_sm, registers=regs, sms=sms)


def obs_tail_static_v2(static_imgp, map_idx, row0, lane0, rext, lext, words, gplus, geom, out_w: int, wide: bool = False):
    """B1 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (words int32[E, A, out_w], attempted
    int32[E, A]). Counts kernel launches in ``obs_tail_static_v2.launches``
    and keeps the last launch's record (``launch``) in
    ``obs_tail_static_v2.last_launch``."""
    if static_imgp.device.type == "cpu":
        return obs_tail_static_v2_ref(static_imgp, map_idx, row0, lane0, rext, lext, words, gplus, geom, out_w, wide)
    if static_imgp.device.type != "cuda":
        raise ValueError(f"obs_tail_static_v2 runs on CUDA or CPU tensors, not {static_imgp.device}")
    out, attempted, obs_tail_static_v2.last_launch = launch_plans(
        None, static_imgp, map_idx, row0, lane0, rext, lext, words, gplus, geom, out_w, wide
    )
    count_launch(obs_tail_static_v2)
    return out, attempted


def launch_plans(plans, static_imgp, map_idx, row0, lane0, rext, lext, words, gplus, geom, out_w: int, wide: bool):
    """The CUDA kernel on CUDA tensors with the best of ``plans`` (None: every
    candidate plan of tail_plan, as the wrapper launches it; one plan to time
    it alone, tools/tail_sweep.py). Returns (words, attempted, the launch's
    record); counts no launch. Raises where the plans cannot hold the
    shapes (tail_plan.check_holds)."""
    check_static_inputs("obs_tail_static_v2", static_imgp, map_idx, row0, lane0, rext, lext, words, gplus, geom, out_w)
    P, HP, WPC = static_imgp.shape
    E, A = row0.shape
    S, G, K = words.shape[2], gplus.shape[2], geom.shape[0]
    if plans is None:
        key = (HP, WPC, A, G, K, S, out_w, tail_plan.MAX_SMEM)
        plans = _PLANS.get(key)
        if plans is None:
            plans = _PLANS[key] = tail_plan.candidate_plans("B1", HP, WPC, A, G, K, S, out_w)
    else:
        tail_plan.check_holds("B1", plans, HP, WPC, G, S, out_w)
    dev = static_imgp.device
    out = torch.empty((E, A, out_w), dtype=torch.int32, device=dev)
    attempted = torch.empty((E, A), dtype=torch.int32, device=dev)
    record = launch(_library(), "obs_tail_static_v2", plans, E, dev, (
        static_imgp.data_ptr(), map_idx.data_ptr(), row0.data_ptr(), lane0.data_ptr(),
        rext.data_ptr(), lext.data_ptr(), words.data_ptr(), gplus.data_ptr(), geom.data_ptr(),
        out.data_ptr(), attempted.data_ptr(),
        P, HP, WPC, E, A, S, G, K, out_w, int(bool(wide)),
    ))
    return out, attempted, record


obs_tail_static_v2.launches = 0
obs_tail_static_v2.last_launch = None


def _library() -> ctypes.CDLL:
    lib = build.load("obs_tail_static_v2")
    fn = lib.obs_tail_static_v2_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
