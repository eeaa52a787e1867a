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
"""

from __future__ import annotations

import ctypes

import torch

from mettagrid_tpu_torch.engine.kernels import build
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import MAX_SMEM, candidates


def smem_bytes(HP: int, WPC: int, K: int, Ch: int, staged: bool) -> int:
    """Shared memory of one block: the env's image when staged, and two
    tables of K*Ch entries."""
    return ((HP * WPC if staged else 0) + 2 * K * Ch) * 4


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
    launches in ``window_slices.launches``."""
    if img.device.type == "cpu":
        return window_slices_ref(img, row0, lane0, geom, Ch)
    if img.device.type != "cuda":
        raise ValueError(f"window_slices runs on CUDA or CPU tensors, not {img.device}")
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
    # Stage the image in shared memory where it fits and loads in 16-byte words.
    staged = int((HP * WPC) % 4 == 0 and img.data_ptr() % 16 == 0 and smem_bytes(HP, WPC, K, Ch, True) <= MAX_SMEM)
    if smem_bytes(HP, WPC, K, Ch, staged) > MAX_SMEM:
        raise ValueError(f"window_slices: the tables of {K} cells x {Ch} channels do not fit shared memory")
    lib = _library()
    out = torch.empty((E, A, K, Ch), dtype=torch.int32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.window_slices_launch(
            img.data_ptr(), row0.data_ptr(), lane0.data_ptr(), geom.data_ptr(), out.data_ptr(),
            E, HP, WPC, A, K, Ch, staged, stream,
        )
    if err != 0:
        raise RuntimeError(f"window_slices: kernel launch failed with cudaError_t {err}")
    window_slices.launches += 1
    return out


window_slices.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("window_slices")
    fn = lib.window_slices_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
