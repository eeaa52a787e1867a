"""Kernel B5: the v1 observation tail over per-env images built beforehand.

Replaces the TPU kernel ``obs_tail_pallas``
(mettagrid_tpu/engine/pallas_kernels.py:211). The CUDA source is
``engine/csrc/obs_tail_v1.cu`` over the persistent machinery of
``obs_tail_bulk.cuh``; its head says what bounds it and how the design
answers that.

The v1 tail serves the configs that the v2 tail's gate turns away (globals
that can be absent, wide feature ids). ``obs_tail_v1`` launches the kernel
for CUDA tensors and takes the plain PyTorch version ``obs_tail_v1_ref`` for
CPU tensors. The launch (persistent blocks, warps per block, the image
staged in shared memory or read from device memory, envs staged ahead) is
planned from the shapes by ``tail_plan``. Both compute, per env e and agent
a, over ``imgp[e]``, int32[HP, WPC] of +1-encoded words (``tail_v1_ref``):

* the candidates: GP global words ``gwords[e, a]`` (+1-encoded, 0 = absent),
  then the image at ``(row0 + u_k, lane0 + v_k*S + s)`` for the K window
  cells of ``geom`` in Manhattan order and s < S; cells outside the image
  read as empty;
* the valid candidates (> 0) as ``(cand - 1) | loc << 16`` words (loc 0xFE
  for the globals), front-compacted stably into ``out[e, a, :out_w]`` with -1
  for empty slots (ranks at or past out_w dropped), and ``attempted[e, a]``,
  the number of valid candidates.
"""

from __future__ import annotations

import ctypes

import torch

from mettagrid_tpu_torch.engine.kernels import build, count_launch, tail_plan
from mettagrid_tpu_torch.engine.kernels.obs_tail_dyn_v2 import check_window_inputs
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import candidates, compact_ref, launch


def tail_v1_ref(img, HP: int, WPC: int, row0, lane0, gwords, geom, S: int, out_w: int):
    """The v1 tail over per-env images img int32[E, HP * WPC] (kernels B4
    and B5 share it)."""
    cells, loc = candidates(img, HP, WPC, row0, lane0, gwords, geom, S)  # [E, A, GP + KS]
    ok = cells > 0
    return compact_ref((cells - 1) | (loc << 16), ok, out_w, -1), ok.sum(dim=-1, dtype=torch.int32)


def obs_tail_v1_ref(imgp, row0, lane0, gwords, geom, S: int, out_w: int):
    """Plain PyTorch version of the kernel (any device). Returns
    (words int32[E, A, out_w], attempted int32[E, A])."""
    E, HP, WPC = imgp.shape
    return tail_v1_ref(imgp.reshape(E, HP * WPC), HP, WPC, row0, lane0, gwords, geom, S, out_w)


def obs_tail_v1(imgp, row0, lane0, gwords, geom, S: int, out_w: int):
    """B5 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (words int32[E, A, out_w], attempted
    int32[E, A]). Counts kernel launches in ``obs_tail_v1.launches`` and
    keeps the last launch's record in ``obs_tail_v1.last_launch``."""
    if imgp.device.type == "cpu":
        return obs_tail_v1_ref(imgp, row0, lane0, gwords, geom, S, out_w)
    if imgp.device.type != "cuda":
        raise ValueError(f"obs_tail_v1 runs on CUDA or CPU tensors, not {imgp.device}")
    out, attempted, obs_tail_v1.last_launch = launch_plans(None, imgp, row0, lane0, gwords, geom, S, out_w)
    count_launch(obs_tail_v1)
    return out, attempted


def launch_plans(plans, imgp, row0, lane0, gwords, geom, S: int, out_w: int):
    """The CUDA kernel on CUDA tensors with the best of ``plans`` (None: every
    candidate plan of tail_plan, as the wrapper launches it; one plan to time
    it alone, tools/tail_sweep.py). Returns (words, attempted, the launch's
    record); counts no launch. Raises where the plans cannot hold the
    shapes (tail_plan.check_holds)."""
    check_window_inputs("obs_tail_v1", imgp, row0, lane0, gwords, geom, S, out_w)
    E, HP, WPC = imgp.shape
    A = row0.shape[1]
    G, K = gwords.shape[2], geom.shape[0]
    if plans is None:
        plans = tail_plan.candidate_plans("B5", HP, WPC, A, G, K, S, out_w)
    else:
        tail_plan.check_holds("B5", plans, HP, WPC, G, S, out_w)
    if any(p.stages for p in plans) and imgp.data_ptr() % 16:
        raise ValueError("obs_tail_v1: a staged image must be 16-byte aligned")
    dev = imgp.device
    out = torch.empty((E, A, out_w), dtype=torch.int32, device=dev)
    attempted = torch.empty((E, A), dtype=torch.int32, device=dev)
    record = launch(_library(), "obs_tail_v1", plans, E, dev, (
        imgp.data_ptr(), row0.data_ptr(), lane0.data_ptr(), gwords.data_ptr(), geom.data_ptr(),
        out.data_ptr(), attempted.data_ptr(), HP, WPC, E, A, S, G, K, out_w,
    ))
    return out, attempted, record


obs_tail_v1.launches = 0
obs_tail_v1.last_launch = None


def _library() -> ctypes.CDLL:
    lib = build.load("obs_tail_v1")
    fn = lib.obs_tail_v1_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
