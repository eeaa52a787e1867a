// The v2 observation tail over row-paired per-env images, written for Hopper
// (sm_90a).
//
// Replaces: obs_tail_dyn_v3_pallas, mettagrid_tpu/engine/pallas_kernels.py:1261
// (kernel B6b), normal packing (the v3 gate excludes the wide one).
//
// What it computes, per env e and agent a: the v2 tail of obs_tail.cuh over
// the two row-paired halves imgp_l[e] and imgp_r[e] (int32 [2*HP2, WPC],
// PairedImage in obs_tail.cuh; the glue in engine/obs.py pairs an image
// built beforehand): the G globals and the window candidates, valid when
// > 0, front-compacted into packed words, and the attempted counts. The
// window of an agent whose image row is r0 reads half row
// (r0 & 1) * HP2 + (r0 >> 1) + (u >> 1) of half u & 1 for its row u, on
// whatever halves it is given: the words equal B3's on the unpaired image
// where the halves are that image's pairing.
//
// What bounds it: bytes. At the arena_mood_v3 shapes (4096 envs x 24 agents,
// HP2 32, WPC 256, G 3, K 121, S 4: 487 candidates, 16 rounds; out_w = 384)
// the output words are 151 MB; of the two 268 MB halves the function needs
// only the words inside some agent's window, each once. The work per byte is
// a few integer operations.
//
// What the design does about it (obs_tail_bulk.cuh): persistent blocks, the
// candidate plan in registers in its paired form (window row u's half is
// bit 0 of the entry's row field, its half row u >> 1), built once per
// block, branch-free rounds with one bounds test per agent, and rows
// compacted in shared memory and bulk-stored. The halves are read from
// device memory through the plan: all of an agent's loads are sent before
// its ballots, the next agent's window rows of both halves are prefetched
// into L2 and its tables loaded ahead, and the warps of a block share the
// env's rows in L1. Only the window words are read. (Staging both halves
// in shared memory, 128 KB per env at the bench shapes, leaves one block
// per SM and took twice as long: PERF.md.)
// No float arithmetic touches a word.

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_tail_bulk.cuh"

namespace {

template <int R, bool kMore>
__global__ void __launch_bounds__(512, 2) obs_tail_dyn_v3_kernel(
    const int* __restrict__ imgp_l,  // [E, 2*HP2, WPC]
    const int* __restrict__ imgp_r,  // [E, 2*HP2, WPC]
    const int* __restrict__ row0,    // [E, A]
    const int* __restrict__ lane0,   // [E, A]
    const int* __restrict__ gplus,   // [E, A, G]
    const int* __restrict__ geom,    // [K, 3]: (u, v, loc) per window cell
    int* __restrict__ out,           // [E, A, out_w]
    int* __restrict__ attempted,     // [E, A]
    int E, int HP2, int WPC, int A, int S, int G, int K, int out_w) {
  // Shared memory: each warp's two row buffers.
  extern __shared__ __align__(128) unsigned char smem[];
  const tail_bulk::V2Pack fmt(0);
  tail_bulk::device_envs<R, kMore>(fmt, geom, tail_bulk::DevicePaired{imgp_l, imgp_r, HP2, WPC}, row0, lane0,
                                   gplus, out, attempted, E, A, G, K, S, out_w, smem);
}

using KernelFn = void (*)(const int*, const int*, const int*, const int*, const int*, const int*, int*, int*, int,
                          int, int, int, int, int, int, int);

// The dynamic shared memory each instance is allowed, by round count (33:
// the instance with plan entries in shared memory).
int allowed_smem[34] = {};

// The instance for `rounds` candidate rounds (above 32: the one whose plan
// keeps the rounds past 12 in shared memory), with its dynamic shared memory
// allowed up to at least `smem` bytes; null for an unknown round count, or
// for `stages` other than 0 (the halves are read from device memory).
KernelFn instance(int rounds, int stages, int smem, cudaError_t* err) {
  KernelFn k = nullptr;
  if (stages == 0) {
    switch (rounds) {
      case 4: k = obs_tail_dyn_v3_kernel<4, false>; break;
      case 8: k = obs_tail_dyn_v3_kernel<8, false>; break;
      case 12: k = obs_tail_dyn_v3_kernel<12, false>; break;
      case 16: k = obs_tail_dyn_v3_kernel<16, false>; break;
      case 24: k = obs_tail_dyn_v3_kernel<24, false>; break;
      case 32: k = obs_tail_dyn_v3_kernel<32, false>; break;
      default: k = rounds > 32 ? obs_tail_dyn_v3_kernel<12, true> : nullptr; break;
    }
  }
  int* allowed = &allowed_smem[rounds > 32 ? 33 : rounds];
  *err = k == nullptr ? cudaErrorInvalidValue : tail_bulk::allow_smem((const void*)k, smem, allowed);
  return k;
}

}  // namespace

// Blocks per SM (out[0]) and registers per thread (out[1]) of the instance
// at `warps` warps per block and `smem` bytes of dynamic shared memory;
// returns the cudaError_t.
extern "C" int obs_tail_dyn_v3_occupancy(int rounds, int stages, int warps, int smem, int* out) {
  cudaError_t err;
  KernelFn k = instance(rounds, stages, smem, &err);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  out[1] = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k, 32 * warps, smem);
}

// Launches the kernel on `stream` with `grid` persistent blocks of `warps`
// warps; returns the cudaError_t of the launch.
extern "C" int obs_tail_dyn_v3_launch(
    const void* imgp_l, const void* imgp_r, const void* row0, const void* lane0, const void* gplus,
    const void* geom, void* out, void* attempted, int HP2, int WPC, int E, int A, int S, int G, int K,
    int out_w, int rounds, int stages, int warps, int grid, int smem, void* stream) {
  cudaError_t err;
  KernelFn k = instance(rounds, stages, smem, &err);
  if (err != cudaSuccess) return (int)err;
  k<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int*)imgp_l, (const int*)imgp_r, (const int*)row0, (const int*)lane0, (const int*)gplus,
      (const int*)geom, (int*)out, (int*)attempted, E, HP2, WPC, A, S, G, K, out_w);
  return (int)cudaGetLastError();
}
