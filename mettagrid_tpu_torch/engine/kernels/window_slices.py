"""Kernel B7: each agent's window of the padded interleaved cell image.

Replaces the TPU kernel ``window_slices_pallas``
(mettagrid_tpu/engine/pallas_kernels.py:154). The CUDA source is
``engine/csrc/window_slices.cu``; its head says what bounds it and how the
design answers that.

``window_slices`` launches the kernel for CUDA tensors and takes the plain
PyTorch version ``window_slices_ref`` for CPU tensors. Both compute, for the
image ``img`` int32[E, HP, WPC] of Ch interleaved channels per cell, every
agent's window in Manhattan order: ``out[e, a, k, c] = img[e, row0[e, a] +
u_k, lane0[e, a] + v_k*Ch + c]`` for the K window cells of ``geom`` (rows
``(u, v, loc)``) and c < Ch, 0 outside the image. The TPU kernel wrote [RP,
LP] tiles holding the window in ``[:OH, :OW*Ch]`` and the caller took the
Manhattan order; here the order is written directly.

The launch is planned from the shapes (``window_plans``, ``window_plan``):
the words per window entry (16-byte units of a cell where every cell and
image row is whole 16-byte units and the image is 16-byte aligned, else
words) and per store (16 bytes where an env's output is whole 16-byte
units, else words), on one persistent block of WARPS warps per SM
(``launch_plan``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from mettagrid_tpu_torch.engine.kernels import build, count_launch, tail_plan
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import MAX_SMEM, candidates

# Warps per block, one block per SM: on full_combat's images more blocks
# per SM put more images in flight than L2 holds and were slower at every
# count tried; territory's smaller images gained at most 4% from them
# (PERF.md).
WARPS = 32
BLOCKS_PER_SM = 1


class WindowPlan(NamedTuple):
    vec: int  # words per window entry: 4 (16-byte units of a cell) or 1
    store: int  # words per store: 4 (16 bytes) or 1
    warps: int  # warps per block
    smem_bytes: int  # dynamic shared memory per block: the entry table


def table_bytes(K: int, Ch: int, vec: int) -> int:
    """The kernel's table: one (row, lane offset) int pair per entry of vec
    words of the window."""
    return K * Ch // vec * 8


def window_plans(WPC: int, A: int, K: int, Ch: int, aligned: bool = True, max_smem: int = None) -> list:
    """Every plan that holds the shapes, narrowest first: word entries and
    word stores; word entries stored four at a time where an env's output
    (A*K*Ch words) is whole 16-byte units and a window has at least four
    words; 16-byte entries where every cell (Ch words) and image row (WPC)
    is whole 16-byte units and the image is 16-byte aligned (``aligned``).
    Raises, with the reason, where no plan's table fits ``max_smem``
    (MAX_SMEM by default)."""
    max_smem = MAX_SMEM if max_smem is None else max_smem
    shapes = [(1, 1)]
    if K * Ch >= 4 and A * K * Ch % 4 == 0:
        shapes.append((1, 4))
    if Ch % 4 == 0 and WPC % 4 == 0 and aligned:
        shapes.append((4, 4))
    plans = [WindowPlan(vec, store, WARPS, table_bytes(K, Ch, vec)) for vec, store in shapes]
    plans = [p for p in plans if p.smem_bytes <= max_smem]
    if not plans:
        raise ValueError(f"window_slices: the table of {K} cells x {Ch} channels ({table_bytes(K, Ch, 1)} bytes) "
                         f"does not fit shared memory ({max_smem} bytes)")
    return plans


def window_plan(WPC: int, A: int, K: int, Ch: int, aligned: bool = True, max_smem: int = None) -> WindowPlan:
    """The plan the wrapper launches: the widest entries and stores that
    hold the shapes (the last of ``window_plans``)."""
    return window_plans(WPC, A, K, Ch, aligned, max_smem)[-1]


def window_slices_ref(img, row0, lane0, geom, Ch: int):
    """Plain PyTorch version of the kernel (any device): an index gather.
    Returns int32[E, A, K, Ch]."""
    E, HP, WPC = img.shape
    A, K = row0.shape[1], geom.shape[0]
    cells, _ = candidates(img.reshape(E, HP * WPC), HP, WPC, row0, lane0, img.new_zeros((E, A, 0)), geom, Ch)
    return cells.reshape(E, A, K, Ch)


def window_slices(img, row0, lane0, geom, Ch: int):
    """B7 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns int32[E, A, K, Ch]. Counts kernel
    launches in ``window_slices.launches`` and keeps the last launch's
    record in ``window_slices.last_launch``."""
    if img.device.type == "cpu":
        return window_slices_ref(img, row0, lane0, geom, Ch)
    if img.device.type != "cuda":
        raise ValueError(f"window_slices runs on CUDA or CPU tensors, not {img.device}")
    out, window_slices.last_launch = launch_plan(None, img, row0, lane0, geom, Ch)
    count_launch(window_slices)
    return out


window_slices.launches = 0
window_slices.last_launch = None


def launch_plan(plan, img, row0, lane0, geom, Ch: int):
    """The CUDA kernel on CUDA tensors with ``plan`` (None: the plan of
    ``window_plan``, as the wrapper launches it; one of ``window_plans`` to
    launch it alone) on a persistent grid of BLOCKS_PER_SM blocks per SM,
    no more blocks than envs. Returns (windows, the launch's record: grid,
    warps, words per entry and per store, shared bytes, blocks per SM the
    card allows, registers, SMs); counts no launch."""
    for arg, t in dict(img=img, row0=row0, lane0=lane0, geom=geom).items():
        if t.device != img.device:
            raise ValueError(f"window_slices: {arg} is on {t.device}, img on {img.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"window_slices: {arg} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"window_slices: {arg} must be contiguous")
    if img.dim() != 3 or row0.dim() != 2 or geom.dim() != 2 or geom.shape[1] != 3:
        raise ValueError("window_slices: wrong ranks or geom shape")
    E, HP, WPC = img.shape
    A, K = row0.shape[1], geom.shape[0]
    if tuple(row0.shape) != (E, A) or tuple(lane0.shape) != (E, A):
        raise ValueError(f"window_slices: row0 {tuple(row0.shape)} and lane0 {tuple(lane0.shape)} must be ({E}, A)")
    if E < 1 or A < 1 or K < 1 or Ch < 1 or HP < 1 or WPC < 1:
        raise ValueError("window_slices: empty batch, agent set, window, channel set or image")
    aligned = img.data_ptr() % 16 == 0
    plans = window_plans(WPC, A, K, Ch, aligned)
    if plan is None:
        plan = window_plan(WPC, A, K, Ch, aligned)
    elif plan not in plans:
        raise ValueError(f"window_slices: {plan} does not hold the shapes (plans: {plans})")
    lib = _library()
    blocks_per_sm, regs, sms = tail_plan.occupancy(lib, "window_slices", plan, img.device)
    grid = tail_plan.persistent_grid(E, sms, min(blocks_per_sm, BLOCKS_PER_SM))
    out = torch.empty((E, A, K, Ch), dtype=torch.int32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.window_slices_launch(
            img.data_ptr(), row0.data_ptr(), lane0.data_ptr(), geom.data_ptr(), out.data_ptr(),
            E, HP, WPC, A, K, Ch, plan.vec, plan.store, plan.warps, grid, plan.smem_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"window_slices: kernel launch failed with cudaError_t {err}")
    return out, dict(grid=grid, warps=plan.warps, vec=plan.vec, store=plan.store, smem_bytes=plan.smem_bytes,
                     blocks_per_sm=blocks_per_sm, registers=regs, sms=sms)


def _library() -> ctypes.CDLL:
    lib = build.load("window_slices")
    fn = lib.window_slices_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
