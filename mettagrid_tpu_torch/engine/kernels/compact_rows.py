"""Kernel B8: stable front-compaction of each row's non-negative words.

Replaces the TPU kernel ``compact_rows_pallas``
(mettagrid_tpu/engine/pallas_kernels.py:110, with ``_compact_block`` and
``_prefix_sum_lanes``). The CUDA source is ``engine/csrc/compact_rows.cu``;
its head says what bounds it and how the design answers that.

``compact_rows`` launches the kernel for CUDA tensors and takes the plain
PyTorch version ``compact_rows_ref`` for CPU tensors. Both return, for
``words`` int32[R, C] whose negative entries are invalid, int32[R, T]: each
row's non-negative words in order, then -1; words at ranks T and beyond
are dropped.
"""

from __future__ import annotations

import ctypes

import torch

from mettagrid_tpu_torch.engine.kernels import build, count_launch
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import compact_ref


def compact_rows_ref(words, T: int):
    """Plain PyTorch version of the kernel (any device). Returns int32[R, T]."""
    return compact_ref(words[None], words[None] >= 0, T, -1)[0]


def compact_rows(words, T: int):
    """B8 on the tensor's device: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Returns int32[R, T]. Counts kernel launches in
    ``compact_rows.launches``."""
    if words.device.type == "cpu":
        return compact_rows_ref(words, T)
    if words.device.type != "cuda":
        raise ValueError(f"compact_rows runs on CUDA or CPU tensors, not {words.device}")
    if words.dtype != torch.int32 or words.dim() != 2 or not words.is_contiguous():
        raise ValueError(f"compact_rows: words must be contiguous int32[R, C], got {words.dtype} {tuple(words.shape)}")
    R, C = words.shape
    if R < 1 or C < 1 or T < 1:
        raise ValueError(f"compact_rows: empty rows, row or budget ({R}, {C}, {T})")
    lib = _library()
    out = torch.empty((R, T), dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = lib.compact_rows_launch(words.data_ptr(), out.data_ptr(), R, C, T, stream)
    if err != 0:
        raise RuntimeError(f"compact_rows: kernel launch failed with cudaError_t {err}")
    count_launch(compact_rows)
    return out


compact_rows.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("compact_rows")
    fn = lib.compact_rows_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
