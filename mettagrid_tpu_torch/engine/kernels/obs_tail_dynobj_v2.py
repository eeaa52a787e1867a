"""Kernel B2: the fused observation tail for mutable-background configs,
with each env's image built from the object tables.

Replaces the TPU kernel ``obs_tail_dynobj_v2_pallas``
(mettagrid_tpu/engine/pallas_kernels.py:1104). The CUDA source is
``engine/csrc/obs_tail_dynobj_v2.cu``; its head says what bounds it and how
the design answers that.

``obs_tail_dynobj_v2`` launches the kernel for CUDA tensors and takes the
plain PyTorch version ``obs_tail_dynobj_v2_ref`` for CPU tensors. The launch
(persistent blocks, warps per block, envs whose tables are staged ahead) is
planned from the shapes by ``tail_plan``. Both compute,
per env e:

* the env image, int32[HP, WPC], zero except that every object n adds its S
  words ``words[e, n, s]`` at ``(rext[e, n], lext[e, n] + s)``; positions
  outside the image add nothing, and dead objects carry zero words whatever
  their stale coordinates;
* then kernel B1's tail, per agent: the G global words, the window at
  ``(row0 + u_k, lane0 + v_k*S + s)`` in Manhattan order (``geom``),
  validity as > 0, stable front-compaction into ``out_w`` words
  ``loc | feat << 8 | val << 16`` (0xFFFFFF for empty slots), normal or
  wide packing, and the attempted counts.
"""

from __future__ import annotations

import ctypes

import torch

from mettagrid_tpu_torch.engine.kernels import build, count_launch, tail_plan
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import add_words, launch, tail_ref


def obs_tail_dynobj_v2_ref(rext, lext, words, row0, lane0, gplus, geom, HP: int, WPC: int, out_w: int, wide: bool = False):
    """Plain PyTorch version of the kernel (any device). Returns
    (words int32[E, A, out_w], attempted int32[E, A])."""
    E = rext.shape[0]
    img = add_words(torch.zeros((E, HP * WPC), dtype=torch.int32, device=rext.device), HP, WPC, rext, lext, words)
    return tail_ref(img, HP, WPC, row0, lane0, gplus, geom, words.shape[2], out_w, wide)


def _check(rext, lext, words, row0, lane0, gplus, geom, HP, WPC, out_w):
    dev = rext.device
    named = dict(rext=rext, lext=lext, words=words, row0=row0, lane0=lane0, gplus=gplus, geom=geom)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"obs_tail_dynobj_v2: {name} is on {t.device}, rext on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"obs_tail_dynobj_v2: {name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"obs_tail_dynobj_v2: {name} must be contiguous")
    if rext.dim() != 2 or row0.dim() != 2 or words.dim() != 3 or gplus.dim() != 3 or geom.dim() != 2:
        raise ValueError("obs_tail_dynobj_v2: wrong ranks")
    E, N = rext.shape
    A = row0.shape[1]
    S, G, K = words.shape[2], gplus.shape[2], geom.shape[0]
    for name, t, shape in (
        ("lext", lext, (E, N)), ("words", words, (E, N, S)), ("row0", row0, (E, A)),
        ("lane0", lane0, (E, A)), ("gplus", gplus, (E, A, G)), ("geom", geom, (K, 3)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"obs_tail_dynobj_v2: {name} has shape {tuple(t.shape)}, expected {shape}")
    if E < 1 or N < 1 or A < 1 or S < 1 or HP < 1 or WPC < 1 or out_w < 1:
        raise ValueError("obs_tail_dynobj_v2: empty batch, object set, agent set, slot set, image or output")
    if (HP * WPC) % 4:
        raise ValueError("obs_tail_dynobj_v2: the image must be a whole number of 16-byte rows")


def obs_tail_dynobj_v2(rext, lext, words, row0, lane0, gplus, geom, HP: int, WPC: int, out_w: int, wide: bool = False):
    """B2 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (words int32[E, A, out_w], attempted
    int32[E, A]). Counts kernel launches in ``obs_tail_dynobj_v2.launches``
    and keeps the last launch's record in ``obs_tail_dynobj_v2.last_launch``."""
    if rext.device.type == "cpu":
        return obs_tail_dynobj_v2_ref(rext, lext, words, row0, lane0, gplus, geom, HP, WPC, out_w, wide)
    if rext.device.type != "cuda":
        raise ValueError(f"obs_tail_dynobj_v2 runs on CUDA or CPU tensors, not {rext.device}")
    out, attempted, obs_tail_dynobj_v2.last_launch = launch_plans(
        None, rext, lext, words, row0, lane0, gplus, geom, HP, WPC, out_w, wide
    )
    count_launch(obs_tail_dynobj_v2)
    return out, attempted


def launch_plans(plans, rext, lext, words, row0, lane0, gplus, geom, HP: int, WPC: int, out_w: int, wide: bool):
    """The CUDA kernel on CUDA tensors with the best of ``plans`` (None: every
    candidate plan of tail_plan, as the wrapper launches it; one plan to time
    it alone, tools/tail_sweep.py). Returns (words, attempted, the launch's
    record); counts no launch. Raises where the plans cannot hold the
    shapes (tail_plan.check_holds)."""
    _check(rext, lext, words, row0, lane0, gplus, geom, HP, WPC, out_w)
    E, N = rext.shape
    A = row0.shape[1]
    S, G, K = words.shape[2], gplus.shape[2], geom.shape[0]
    if plans is None:
        plans = tail_plan.candidate_plans("B2", HP, WPC, A, G, K, S, out_w, N=N)
    else:
        tail_plan.check_holds("B2", plans, HP, WPC, G, S, out_w)
    dev = rext.device
    out = torch.empty((E, A, out_w), dtype=torch.int32, device=dev)
    attempted = torch.empty((E, A), dtype=torch.int32, device=dev)
    record = launch(_library(), "obs_tail_dynobj_v2", plans, E, dev, (
        rext.data_ptr(), lext.data_ptr(), words.data_ptr(), row0.data_ptr(), lane0.data_ptr(),
        gplus.data_ptr(), geom.data_ptr(), out.data_ptr(), attempted.data_ptr(),
        HP, WPC, E, N, A, S, G, K, out_w, int(bool(wide)),
    ))
    return out, attempted, record


obs_tail_dynobj_v2.launches = 0
obs_tail_dynobj_v2.last_launch = None


def _library() -> ctypes.CDLL:
    lib = build.load("obs_tail_dynobj_v2")
    fn = lib.obs_tail_dynobj_v2_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
