"""Kernel B6b: the v2 observation tail over row-paired per-env images.

Replaces the TPU kernel ``obs_tail_dyn_v3_pallas``
(mettagrid_tpu/engine/pallas_kernels.py:1261). The CUDA source is
``engine/csrc/obs_tail_dyn_v3.cu`` over the persistent machinery of
``obs_tail_bulk.cuh``; its head says what bounds it and how the design
answers that.

An image int32[HP, WPC] is held as two row-paired halves, left and right,
each int32[2*HP2, WPC] (engine/obs.py ``pair_rows``): rows u < HP2 of the
left half hold image rows 2u and of the right half 2u + 1, rows HP2 + u hold
image rows 2u + 1 and 2u + 2. A window that starts at image row r reads its
row 2k from ``left[base + k]`` and its row 2k + 1 from ``right[base + k]``,
where ``base = (r & 1) * HP2 + (r >> 1)``.

``obs_tail_dyn_v3`` launches the kernel for CUDA tensors and takes the plain
PyTorch version ``obs_tail_dyn_v3_ref`` for CPU tensors. The launch
(persistent blocks, warps per block; the halves are read from device
memory) is planned from the shapes by ``tail_plan``. Both compute B3's
words (``obs_tail_static_v2.v2_words_ref``) through those paired reads: per
agent the G global words, the window at ``(row0 + u_k, lane0 + v_k*S + s)``
in Manhattan order (``geom``; cells outside the image read as empty),
validity as > 0, stable front-compaction into ``out_w`` words ``loc | feat
<< 8 | val << 16`` (0xFFFFFF for empty slots, normal packing), and the
attempted counts.
"""

from __future__ import annotations

import ctypes

import torch

from mettagrid_tpu_torch.engine.kernels import build, count_launch, tail_plan
from mettagrid_tpu_torch.engine.kernels.obs_tail_dyn_v2 import check_window_inputs
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import launch, v2_words_ref
from mettagrid_tpu_torch.engine.program import GLOBAL_LOCATION


def paired_candidates(left, right, row0, lane0, front, geom, S: int):
    """Each agent's candidate cells int32[E, A, F + K*S] over per-env paired
    halves left, right int32[E, 2*HP2, WPC]: the F ``front`` words, then the
    window cells in Manhattan order read through the pairing (cells outside
    the halves read 0), and the location byte of each candidate (0xFE for
    the front words)."""
    E, HP2x2, WPC = left.shape
    HP2 = HP2x2 // 2
    A = row0.shape[1]
    dev = row0.device
    i32 = torch.int32
    s_ = torch.arange(S, dtype=i32, device=dev)
    du = geom[:, 0].repeat_interleave(S)  # [KS] window row per candidate
    dl = (geom[:, 1][:, None] * S + s_[None, :]).reshape(-1)  # [KS] window lane
    base = (row0 & 1) * HP2 + (row0 >> 1)  # [E, A]
    rr = base[..., None] + (du >> 1)  # [E, A, KS]: row within the half
    ll = lane0[..., None] + dl
    inside = (rr >= 0) & (rr < HP2x2) & (ll >= 0) & (ll < WPC)
    half = (du & 1) * HP2x2  # the right half follows the left one
    KS = du.shape[0]
    img = torch.cat([left, right], dim=1).reshape(E, 2 * HP2x2 * WPC)
    at = torch.where(inside, (half + rr) * WPC + ll, 0).reshape(E, A * KS).long()
    cand = torch.where(inside, img.gather(1, at).reshape(E, A, KS), 0)
    F = front.shape[2]
    loc = torch.cat([torch.full((F,), GLOBAL_LOCATION, dtype=i32, device=dev), geom[:, 2].repeat_interleave(S)])
    return torch.cat([front, cand], dim=-1), loc


def obs_tail_dyn_v3_ref(imgp_l, imgp_r, row0, lane0, gplus, geom, S: int, out_w: int):
    """Plain PyTorch version of the kernel (any device). Returns
    (words int32[E, A, out_w], attempted int32[E, A])."""
    return v2_words_ref(*paired_candidates(imgp_l, imgp_r, row0, lane0, gplus, geom, S), out_w, False)


def check_pair(name, left, right):
    """The right half matches the left one: device, type, shape, layout, an
    even number of rows."""
    if right.device != left.device or right.dtype != left.dtype or right.shape != left.shape:
        raise ValueError(f"{name}: the right half differs from the left one in device, dtype or shape")
    if not right.is_contiguous():
        raise ValueError(f"{name}: the right half must be contiguous")
    if left.dim() != 3 or left.shape[1] % 2:
        raise ValueError(f"{name}: each half must be [*, 2*HP2, WPC]")


def obs_tail_dyn_v3(imgp_l, imgp_r, row0, lane0, gplus, geom, S: int, out_w: int):
    """B6b on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (words int32[E, A, out_w], attempted
    int32[E, A]). Counts kernel launches in ``obs_tail_dyn_v3.launches`` and
    keeps the last launch's record in ``obs_tail_dyn_v3.last_launch``."""
    if imgp_l.device.type == "cpu":
        return obs_tail_dyn_v3_ref(imgp_l, imgp_r, row0, lane0, gplus, geom, S, out_w)
    if imgp_l.device.type != "cuda":
        raise ValueError(f"obs_tail_dyn_v3 runs on CUDA or CPU tensors, not {imgp_l.device}")
    out, attempted, obs_tail_dyn_v3.last_launch = launch_plans(
        None, imgp_l, imgp_r, row0, lane0, gplus, geom, S, out_w
    )
    count_launch(obs_tail_dyn_v3)
    return out, attempted


def launch_plans(plans, imgp_l, imgp_r, row0, lane0, gplus, geom, S: int, out_w: int):
    """The CUDA kernel on CUDA tensors with the best of ``plans`` (None: every
    candidate plan of tail_plan, as the wrapper launches it; one plan to time
    it alone, tools/tail_sweep.py). Returns (words, attempted, the launch's
    record); counts no launch. Raises where the plans cannot hold the
    shapes (tail_plan.check_holds)."""
    check_window_inputs("obs_tail_dyn_v3", imgp_l, row0, lane0, gplus, geom, S, out_w)
    check_pair("obs_tail_dyn_v3", imgp_l, imgp_r)
    E, HP2x2, WPC = imgp_l.shape
    A = row0.shape[1]
    G, K = gplus.shape[2], geom.shape[0]
    if plans is None:
        plans = tail_plan.candidate_plans("B6b", HP2x2, WPC, A, G, K, S, out_w)
    else:
        tail_plan.check_holds("B6b", plans, HP2x2, WPC, G, S, out_w)
    dev = imgp_l.device
    out = torch.empty((E, A, out_w), dtype=torch.int32, device=dev)
    attempted = torch.empty((E, A), dtype=torch.int32, device=dev)
    record = launch(_library(), "obs_tail_dyn_v3", plans, E, dev, (
        imgp_l.data_ptr(), imgp_r.data_ptr(), row0.data_ptr(), lane0.data_ptr(), gplus.data_ptr(),
        geom.data_ptr(), out.data_ptr(), attempted.data_ptr(), HP2x2 // 2, WPC, E, A, S, G, K, out_w,
    ))
    return out, attempted, record


obs_tail_dyn_v3.launches = 0
obs_tail_dyn_v3.last_launch = None


def _library() -> ctypes.CDLL:
    lib = build.load("obs_tail_dyn_v3")
    fn = lib.obs_tail_dyn_v3_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
