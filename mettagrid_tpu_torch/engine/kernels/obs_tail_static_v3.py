"""Kernel B6a: the v2 observation tail over the row-paired static pool.

Replaces the TPU kernel ``obs_tail_static_v3_pallas``
(mettagrid_tpu/engine/pallas_kernels.py:792). The CUDA source is
``engine/csrc/obs_tail_static_v3.cu`` over the persistent machinery of
``obs_tail_bulk.cuh``; its head says what bounds it and how the design
answers that.

The pool holds each map's padded image as two row-paired halves, left and
right, int32[P, 2*HP2, WPC] each (the layout of ``obs_tail_dyn_v3``).
``obs_tail_static_v3`` launches the kernel for CUDA tensors and takes the
plain PyTorch version ``obs_tail_static_v3_ref`` for CPU tensors. The launch
(persistent blocks, warps per block; each env staged just before its tail)
is planned from the shapes by ``tail_plan``. Both compute, per env e and agent a:

* the env's halves: ``static_l[map_idx[e]]`` and ``static_r[map_idx[e]]``,
  with every agent's S words added once to each, at its image row R = rext
  (left row ``(R&1)*HP2 + (R>>1)``, right row ``(1-(R&1))*HP2 +
  ((R-1)>>1)``; R >= 1) and lanes ``lext + s``;
* B1's words over them (``obs_tail_dyn_v3.paired_candidates``): the G global
  words, the window cells in Manhattan order, validity as > 0, stable
  front-compaction into ``out_w`` words (normal packing), and the attempted
  counts.
"""

from __future__ import annotations

import ctypes

import torch

from mettagrid_tpu_torch.engine.kernels import build, count_launch, tail_plan
from mettagrid_tpu_torch.engine.kernels.obs_tail_dyn_v3 import check_pair, paired_candidates
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import add_words, check_static_inputs, launch, v2_words_ref
from mettagrid_tpu_torch.profiling import trace


def _agent_rows(rext, HP2: int):
    """(left row, right row) of the halves that hold image row rext."""
    odd = rext & 1
    return odd * HP2 + (rext >> 1), (1 - odd) * HP2 + ((rext - 1) >> 1)


def obs_tail_static_v3_ref(static_l, static_r, map_idx, row0, lane0, rext, lext, words, gplus, geom, out_w: int):
    """Plain PyTorch version of the kernel (any device). Returns
    (words int32[E, A, out_w], attempted int32[E, A])."""
    if trace.host_read((rext < 1).any(), "obs.v3_row0"):
        raise ValueError("obs_tail_static_v3: an agent sits on image row 0, which the pairing cannot hold")
    _, HP2x2, WPC = static_l.shape
    E = row0.shape[0]
    idx = map_idx.long()
    row_l, row_r = _agent_rows(rext, HP2x2 // 2)
    left = add_words(static_l[idx].reshape(E, HP2x2 * WPC), HP2x2, WPC, row_l, lext, words)
    right = add_words(static_r[idx].reshape(E, HP2x2 * WPC), HP2x2, WPC, row_r, lext, words)
    cells, loc = paired_candidates(
        left.view(E, HP2x2, WPC), right.view(E, HP2x2, WPC), row0, lane0, gplus, geom, words.shape[2]
    )
    return v2_words_ref(cells, loc, out_w, False)


def obs_tail_static_v3(static_l, static_r, map_idx, row0, lane0, rext, lext, words, gplus, geom, out_w: int):
    """B6a on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (words int32[E, A, out_w], attempted
    int32[E, A]). Counts kernel launches in ``obs_tail_static_v3.launches``
    and keeps the last launch's record in ``obs_tail_static_v3.last_launch``."""
    if static_l.device.type == "cpu":
        return obs_tail_static_v3_ref(static_l, static_r, map_idx, row0, lane0, rext, lext, words, gplus, geom, out_w)
    if static_l.device.type != "cuda":
        raise ValueError(f"obs_tail_static_v3 runs on CUDA or CPU tensors, not {static_l.device}")
    out, attempted, obs_tail_static_v3.last_launch = launch_plans(
        None, static_l, static_r, map_idx, row0, lane0, rext, lext, words, gplus, geom, out_w
    )
    count_launch(obs_tail_static_v3)
    return out, attempted


def launch_plans(plans, static_l, static_r, map_idx, row0, lane0, rext, lext, words, gplus, geom, out_w: int):
    """The CUDA kernel on CUDA tensors with the best of ``plans`` (None: every
    candidate plan of tail_plan, as the wrapper launches it; one plan to time
    it alone, tools/tail_sweep.py). Returns (words, attempted, the launch's
    record); counts no launch. Raises where the plans cannot hold the
    shapes (tail_plan.check_holds)."""
    name = "obs_tail_static_v3"
    check_static_inputs(name, static_l, map_idx, row0, lane0, rext, lext, words, gplus, geom, out_w)
    check_pair(name, static_l, static_r)
    if static_r.data_ptr() % 16:
        raise ValueError(f"{name}: the right half must be 16-byte aligned")
    P, HP2x2, WPC = static_l.shape
    E, A = row0.shape
    S, G, K = words.shape[2], gplus.shape[2], geom.shape[0]
    if plans is None:
        plans = tail_plan.candidate_plans("B6a", HP2x2, WPC, A, G, K, S, out_w)
    else:
        tail_plan.check_holds("B6a", plans, HP2x2, WPC, G, S, out_w)
    dev = static_l.device
    out = torch.empty((E, A, out_w), dtype=torch.int32, device=dev)
    attempted = torch.empty((E, A), dtype=torch.int32, device=dev)
    record = launch(_library(), name, plans, E, dev, (
        static_l.data_ptr(), static_r.data_ptr(), map_idx.data_ptr(), row0.data_ptr(), lane0.data_ptr(),
        rext.data_ptr(), lext.data_ptr(), words.data_ptr(), gplus.data_ptr(), geom.data_ptr(),
        out.data_ptr(), attempted.data_ptr(), P, HP2x2 // 2, WPC, E, A, S, G, K, out_w,
    ))
    return out, attempted, record


obs_tail_static_v3.launches = 0
obs_tail_static_v3.last_launch = None


def _library() -> ctypes.CDLL:
    lib = build.load("obs_tail_static_v3")
    fn = lib.obs_tail_static_v3_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
