"""Kernel B3: the v2 observation tail over per-env images built beforehand.

Replaces the TPU kernel ``obs_tail_dyn_v2_pallas``
(mettagrid_tpu/engine/pallas_kernels.py:970). The CUDA source is
``engine/csrc/obs_tail_dyn_v2.cu`` over the persistent machinery of
``obs_tail_bulk.cuh``; its head says what bounds it and how the design
answers that.

It serves the v2 configs whose per-env image is too large for kernels B1 and
B2 to stage in shared memory. ``obs_tail_dyn_v2`` launches the kernel for
CUDA tensors and takes the plain PyTorch version ``obs_tail_dyn_v2_ref``
for CPU tensors. The launch (persistent blocks, warps per block; the image
is read from device memory) is planned from the shapes by ``tail_plan``.
Both compute B1's tail (``obs_tail_static_v2.tail_ref``) over ``imgp[e]``,
int32[HP, WPC] of +1-encoded words: per agent the G global words, the
window at ``(row0 + u_k, lane0 + v_k*S + s)`` in Manhattan order
(``geom``; cells outside the image read as empty), validity as > 0, stable
front-compaction into ``out_w`` words ``loc | feat << 8 | val << 16``
(0xFFFFFF for empty slots), normal or wide packing, and the attempted
counts.
"""

from __future__ import annotations

import ctypes

import torch

from mettagrid_tpu_torch.engine.kernels import build, count_launch, tail_plan
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import launch, tail_ref


def obs_tail_dyn_v2_ref(imgp, row0, lane0, gplus, geom, S: int, out_w: int, wide: bool = False):
    """Plain PyTorch version of the kernel (any device). Returns
    (words int32[E, A, out_w], attempted int32[E, A])."""
    E, HP, WPC = imgp.shape
    return tail_ref(imgp.reshape(E, HP * WPC), HP, WPC, row0, lane0, gplus, geom, S, out_w, wide)


def check_window_inputs(name, imgp, row0, lane0, front, geom, S, out_w):
    """The checks the wrappers of B3, B5 and B6b share: one device, int32,
    contiguous, matching shapes, non-empty."""
    dev = imgp.device
    for arg, t in dict(imgp=imgp, row0=row0, lane0=lane0, front=front, geom=geom).items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, imgp on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if imgp.dim() != 3 or row0.dim() != 2 or front.dim() != 3 or geom.dim() != 2:
        raise ValueError(f"{name}: wrong ranks")
    E, HP, WPC = imgp.shape
    A = row0.shape[1]
    for arg, t, shape in (
        ("row0", row0, (E, A)), ("lane0", lane0, (E, A)), ("globals", front, (E, A, front.shape[2])),
        ("geom", geom, (geom.shape[0], 3)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shape}")
    if E < 1 or A < 1 or HP < 1 or WPC < 1 or S < 1 or out_w < 1:
        raise ValueError(f"{name}: empty batch, agent set, image, slot set or output")


def obs_tail_dyn_v2(imgp, row0, lane0, gplus, geom, S: int, out_w: int, wide: bool = False):
    """B3 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (words int32[E, A, out_w], attempted
    int32[E, A]). Counts kernel launches in ``obs_tail_dyn_v2.launches`` and
    keeps the last launch's record in ``obs_tail_dyn_v2.last_launch``."""
    if imgp.device.type == "cpu":
        return obs_tail_dyn_v2_ref(imgp, row0, lane0, gplus, geom, S, out_w, wide)
    if imgp.device.type != "cuda":
        raise ValueError(f"obs_tail_dyn_v2 runs on CUDA or CPU tensors, not {imgp.device}")
    out, attempted, obs_tail_dyn_v2.last_launch = launch_plans(None, imgp, row0, lane0, gplus, geom, S, out_w, wide)
    count_launch(obs_tail_dyn_v2)
    return out, attempted


def launch_plans(plans, imgp, row0, lane0, gplus, geom, S: int, out_w: int, wide: bool = False):
    """The CUDA kernel on CUDA tensors with the best of ``plans`` (None: every
    candidate plan of tail_plan, as the wrapper launches it; one plan to time
    it alone, tools/tail_sweep.py). Returns (words, attempted, the launch's
    record); counts no launch. Raises where the plans cannot hold the shapes
    (tail_plan.check_holds)."""
    check_window_inputs("obs_tail_dyn_v2", imgp, row0, lane0, gplus, geom, S, out_w)
    E, HP, WPC = imgp.shape
    A = row0.shape[1]
    G, K = gplus.shape[2], geom.shape[0]
    if plans is None:
        plans = tail_plan.candidate_plans("B3", HP, WPC, A, G, K, S, out_w)
    else:
        tail_plan.check_holds("B3", plans, HP, WPC, G, S, out_w)
    dev = imgp.device
    out = torch.empty((E, A, out_w), dtype=torch.int32, device=dev)
    attempted = torch.empty((E, A), dtype=torch.int32, device=dev)
    record = launch(_library(), "obs_tail_dyn_v2", plans, E, dev, (
        imgp.data_ptr(), row0.data_ptr(), lane0.data_ptr(), gplus.data_ptr(), geom.data_ptr(),
        out.data_ptr(), attempted.data_ptr(), HP, WPC, E, A, S, G, K, out_w, int(bool(wide)),
    ))
    return out, attempted, record


obs_tail_dyn_v2.launches = 0
obs_tail_dyn_v2.last_launch = None


def _library() -> ctypes.CDLL:
    lib = build.load("obs_tail_dyn_v2")
    fn = lib.obs_tail_dyn_v2_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
