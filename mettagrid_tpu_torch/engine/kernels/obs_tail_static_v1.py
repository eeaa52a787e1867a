"""Kernel B4: the v1 observation tail for static-background configs.

Replaces the TPU kernel ``obs_tail_static_pallas``
(mettagrid_tpu/engine/pallas_kernels.py:1374). The CUDA source is
``engine/csrc/obs_tail_static_v1.cu``, B1's persistent design
(``obs_tail_bulk.cuh``, static_envs) in the v1 words; its head says what
bounds it and how the design answers that.

``obs_tail_static_v1`` launches the kernel for CUDA tensors and takes the
plain PyTorch version ``obs_tail_static_v1_ref`` for CPU tensors. The launch
(persistent blocks, warps per block, envs staged ahead) is planned from the
shapes by ``tail_plan``. Both compute, per env e and agent a:

* the env image: ``static_imgp[map_idx[e]]`` (+1-encoded token words, 0 =
  empty) plus every agent's S words added at ``(rext, lext + s)``, as B1;
* then the v1 tail (``obs_tail_v1.tail_v1_ref``): GP global words that may
  be absent (0), any number of them, the window candidates in Manhattan
  order, valid when > 0, as ``(cand - 1) | loc << 16`` words front-compacted
  into ``out_w`` words with -1 for empty slots, and the attempted counts.
"""

from __future__ import annotations

import ctypes

import torch

from mettagrid_tpu_torch.engine.kernels import build, count_launch, tail_plan
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import add_words, check_static_inputs, launch
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
    int32[E, A]); on the card the words are the first out_w of rows laid out
    at a pitch of out_w rounded up to 4 (launch_plans). Counts kernel
    launches in ``obs_tail_static_v1.launches`` and keeps the last launch's
    record in ``obs_tail_static_v1.last_launch``."""
    if static_imgp.device.type == "cpu":
        return obs_tail_static_v1_ref(static_imgp, map_idx, row0, lane0, rext, lext, words, gwords, geom, out_w)
    if static_imgp.device.type != "cuda":
        raise ValueError(f"obs_tail_static_v1 runs on CUDA or CPU tensors, not {static_imgp.device}")
    out, attempted, obs_tail_static_v1.last_launch = launch_plans(
        None, static_imgp, map_idx, row0, lane0, rext, lext, words, gwords, geom, out_w
    )
    count_launch(obs_tail_static_v1)
    return out, attempted


def launch_plans(plans, static_imgp, map_idx, row0, lane0, rext, lext, words, gwords, geom, out_w: int):
    """The CUDA kernel on CUDA tensors with the best of ``plans`` (None: every
    candidate plan of tail_plan, as the wrapper launches it; one plan to time
    it alone, tools/tail_sweep.py). The rows are laid out at a pitch of out_w
    rounded up to whole 16-byte units, so that the kernel bulk-stores each
    (the pad holds ranks past out_w), and the first out_w words of each are
    returned. Returns (words, attempted, the launch's record, with the
    pitch); counts no launch. Raises where the plans cannot hold the shapes
    (tail_plan.check_holds)."""
    check_static_inputs("obs_tail_static_v1", static_imgp, map_idx, row0, lane0, rext, lext, words, gwords, geom,
                        out_w)
    P, HP, WPC = static_imgp.shape
    E, A = row0.shape
    S, G, K = words.shape[2], gwords.shape[2], geom.shape[0]
    pitch = (out_w + 3) & ~3
    if plans is None:
        plans = tail_plan.candidate_plans("B4", HP, WPC, A, G, K, S, pitch)
    else:
        tail_plan.check_holds("B4", plans, HP, WPC, G, S, pitch)
    dev = static_imgp.device
    out = torch.empty((E, A, pitch), dtype=torch.int32, device=dev)
    attempted = torch.empty((E, A), dtype=torch.int32, device=dev)
    record = launch(_library(), "obs_tail_static_v1", plans, E, dev, (
        static_imgp.data_ptr(), map_idx.data_ptr(), row0.data_ptr(), lane0.data_ptr(),
        rext.data_ptr(), lext.data_ptr(), words.data_ptr(), gwords.data_ptr(), geom.data_ptr(),
        out.data_ptr(), attempted.data_ptr(),
        P, HP, WPC, E, A, S, G, K, pitch,
    ))
    return out[..., :out_w], attempted, dict(record, pitch=pitch)


obs_tail_static_v1.launches = 0
obs_tail_static_v1.last_launch = None


def _library() -> ctypes.CDLL:
    lib = build.load("obs_tail_static_v1")
    fn = lib.obs_tail_static_v1_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
