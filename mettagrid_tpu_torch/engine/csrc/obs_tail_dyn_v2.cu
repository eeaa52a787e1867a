// The v2 observation tail over per-env images in device memory, written for
// Hopper (sm_90a).
//
// Replaces: obs_tail_dyn_v2_pallas, mettagrid_tpu/engine/pallas_kernels.py:970
// (kernel B3), with normal (`wide` = 0) and wide (`wide` = 1) word packing.
//
// What it computes, per env e and agent a: the v2 tail of obs_tail.cuh
// (B1's and B2's) over imgp[e] (int32 [HP, WPC], +1-encoded words built
// beforehand): the G globals and the window candidates, valid when > 0,
// front-compacted into packed words, and the attempted counts.
//
// It serves the maps whose image B1 or B2 cannot stage: the smallest launch
// plan of either (one stage, one warp's row buffers) above the 232,448 bytes
// of shared memory a block may use (the 128x128 arena: 144 x 512 words,
// 295 KB per env).
//
// What bounds it: bytes. At the arena_128 shapes (4096 envs x 24 agents,
// G 3, K 121, S 3: 366 candidates, 12 rounds; out_w = 256) the output words
// are 101 MB; of the 1.2 GB of images the function needs only the words
// inside some agent's window (about a quarter on a 128x128 map with 24
// agents), each once. The work per byte is a few integer operations.
//
// What the design does about it (obs_tail_bulk.cuh, B6b's device mode over
// a flat image): persistent blocks, the candidate plan in registers (word
// offsets from the window's corner; at most 12 rounds, the entries of any
// further rounds in shared memory), built once per block, branch-free
// rounds with one bounds test per agent, and rows compacted in shared
// memory and bulk-stored. The image is read from device memory through the
// plan: a batch of rounds' loads (all twelve at the bench shapes) goes out
// before their ballots, the next agent's window rows are prefetched into L2
// and its tables loaded ahead, and the warps of a block share the env's
// rows in L1. Only the window words are read. No float arithmetic touches a
// word.

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_tail_bulk.cuh"

namespace {

template <int R, bool kMore>
__global__ void __launch_bounds__(512, 2) obs_tail_dyn_v2_kernel(
    const int* __restrict__ imgp,   // [E, HP, WPC]
    const int* __restrict__ row0,   // [E, A]
    const int* __restrict__ lane0,  // [E, A]
    const int* __restrict__ gplus,  // [E, A, G]
    const int* __restrict__ geom,   // [K, 3]: (u, v, loc) per window cell
    int* __restrict__ out,          // [E, A, out_w]
    int* __restrict__ attempted,    // [E, A]
    int E, int HP, int WPC, int A, int S, int G, int K, int out_w, int wide) {
  // Shared memory: each warp's two row buffers.
  extern __shared__ __align__(128) unsigned char smem[];
  const tail_bulk::V2Pack fmt(wide);
  tail_bulk::device_envs<R, kMore>(fmt, geom, tail_bulk::DeviceFlat{imgp, HP, WPC}, row0, lane0, gplus, out,
                                   attempted, E, A, G, K, S, out_w, smem);
}

using KernelFn = void (*)(const int*, const int*, const int*, const int*, const int*, int*, int*, int, int, int, int,
                          int, int, int, int, int);

// The dynamic shared memory each instance is allowed, by round count (13:
// the instance with plan entries in shared memory).
int allowed_smem[14] = {};

// The instance for `rounds` candidate rounds (above 12: the one whose plan
// keeps the rounds past 12 in shared memory, since register plans of 16 to
// 32 rounds spilled here), with its dynamic shared memory allowed up to at
// least `smem` bytes; null for an unknown round count, or for `stages`
// other than 0 (the image is read from device memory).
KernelFn instance(int rounds, int stages, int smem, cudaError_t* err) {
  KernelFn k = nullptr;
  if (stages == 0) {
    switch (rounds) {
      case 4: k = obs_tail_dyn_v2_kernel<4, false>; break;
      case 8: k = obs_tail_dyn_v2_kernel<8, false>; break;
      case 12: k = obs_tail_dyn_v2_kernel<12, false>; break;
      default: k = rounds > 12 ? obs_tail_dyn_v2_kernel<12, true> : nullptr; break;
    }
  }
  int* allowed = &allowed_smem[rounds > 12 ? 13 : rounds];
  *err = k == nullptr ? cudaErrorInvalidValue : tail_bulk::allow_smem((const void*)k, smem, allowed);
  return k;
}

}  // namespace

// Blocks per SM (out[0]) and registers per thread (out[1]) of the instance
// at `warps` warps per block and `smem` bytes of dynamic shared memory;
// returns the cudaError_t.
extern "C" int obs_tail_dyn_v2_occupancy(int rounds, int stages, int warps, int smem, int* out) {
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
extern "C" int obs_tail_dyn_v2_launch(
    const void* imgp, const void* row0, const void* lane0, const void* gplus, const void* geom,
    void* out, void* attempted, int HP, int WPC, int E, int A, int S, int G, int K, int out_w, int wide,
    int rounds, int stages, int warps, int grid, int smem, void* stream) {
  cudaError_t err;
  KernelFn k = instance(rounds, stages, smem, &err);
  if (err != cudaSuccess) return (int)err;
  k<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int*)imgp, (const int*)row0, (const int*)lane0, (const int*)gplus, (const int*)geom,
      (int*)out, (int*)attempted, E, HP, WPC, A, S, G, K, out_w, wide);
  return (int)cudaGetLastError();
}
