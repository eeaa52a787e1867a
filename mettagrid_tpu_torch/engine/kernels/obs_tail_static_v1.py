"""Kernel B4: the v1 observation tail for static-background configs.

Replaces the TPU kernel ``obs_tail_static_pallas``
(mettagrid_tpu/engine/pallas_kernels.py:1374). The CUDA source is
``engine/csrc/obs_tail_static_v1.cu`` (the tail, which B1-B5 share and
which runs here in its v1 word format, is in ``obs_tail.cuh``); its head says what bounds it and how the design
answers that.

``obs_tail_static_v1`` launches the kernel for CUDA tensors and takes the
plain PyTorch version ``obs_tail_static_v1_ref`` for CPU tensors. Both
compute, per env e and agent a:

* the env image: ``static_imgp[map_idx[e]]`` (+1-encoded token words, 0 =
  empty) plus every agent's S words added at ``(rext, lext + s)``, as B1;
* then the v1 tail (``obs_tail_v1.tail_v1_ref``): GP global words that may
  be absent (0), the window candidates in Manhattan order, valid when > 0,
  as ``(cand - 1) | loc << 16`` words front-compacted into ``out_w`` words
  with -1 for empty slots, and the attempted counts.
"""

from __future__ import annotations

import ctypes

import torch

from mettagrid_tpu_torch.engine.kernels import build
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import add_words, check_static_inputs, staged_smem_bytes
from mettagrid_tpu_torch.engine.kernels.tail_plan import MAX_SMEM
from mettagrid_tpu_torch.engine.kernels.obs_tail_v1 import tail_v1_ref


def obs_tail_static_v1_ref(static_imgp, map_idx, row0, lane0, rext, lext, words, gwords, geom, out_w: int):
    """Plain PyTorch version of the kernel (any device). Returns
    (words int32[E, A, out_w], attempted int32[E, A])."""
    _, HP, WPC = static_imgp.shape
    E = row0.shape[0]
    img = add_words(static_imgp[map_idx.long()].reshape(E, HP * WPC), HP, WPC, rext, lext, words)
    return tail_v1_ref(img, HP, WPC, row0, lane0, gwords, geom, words.shape[2], out_w)


def obs_tail_static_v1(static_imgp, map_idx, row0, lane0, rext, lext, words, gwords, geom, out_w: int):
    """B4 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (words int32[E, A, out_w], attempted
    int32[E, A]). Counts kernel launches in ``obs_tail_static_v1.launches``."""
    if static_imgp.device.type == "cpu":
        return obs_tail_static_v1_ref(static_imgp, map_idx, row0, lane0, rext, lext, words, gwords, geom, out_w)
    if static_imgp.device.type != "cuda":
        raise ValueError(f"obs_tail_static_v1 runs on CUDA or CPU tensors, not {static_imgp.device}")
    check_static_inputs("obs_tail_static_v1", static_imgp, map_idx, row0, lane0, rext, lext, words, gwords, geom, out_w)
    P, HP, WPC = static_imgp.shape
    E, A = row0.shape
    S, GP, K = words.shape[2], gwords.shape[2], geom.shape[0]
    smem = staged_smem_bytes(HP, WPC, K, S)
    if smem > MAX_SMEM:
        raise ValueError(f"obs_tail_static_v1: image + tables need {smem} bytes of shared memory (> {MAX_SMEM})")
    lib = _library()
    dev = static_imgp.device
    out = torch.empty((E, A, out_w), dtype=torch.int32, device=dev)
    attempted = torch.empty((E, A), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.obs_tail_static_v1_launch(
            static_imgp.data_ptr(), map_idx.data_ptr(), row0.data_ptr(), lane0.data_ptr(),
            rext.data_ptr(), lext.data_ptr(), words.data_ptr(), gwords.data_ptr(), geom.data_ptr(),
            out.data_ptr(), attempted.data_ptr(),
            P, HP, WPC, E, A, S, GP, K, out_w, stream,
        )
    if err != 0:
        raise RuntimeError(f"obs_tail_static_v1: kernel launch failed with cudaError_t {err}")
    obs_tail_static_v1.launches += 1
    return out, attempted


obs_tail_static_v1.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("obs_tail_static_v1")
    fn = lib.obs_tail_static_v1_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
