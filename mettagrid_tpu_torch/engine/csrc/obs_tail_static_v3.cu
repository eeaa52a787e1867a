// The v2 observation tail over row-paired static images, written for Hopper
// (sm_90a).
//
// Replaces: obs_tail_static_v3_pallas, mettagrid_tpu/engine/pallas_kernels.py:792
// (kernel B6a), normal packing (the v3 gate excludes the wide one).
//
// What it computes, per env e and agent a:
//   left  = static_l[map_idx[e]], right = static_r[map_idx[e]]: the two
//           row-paired halves (int32 [2*HP2, WPC], PairedImage in
//           obs_tail.cuh) of the env's pooled image;
//   each agent's S words added once to each half, at the agent's image row
//   R = rext: left row (R&1)*HP2 + (R>>1), right row (1-(R&1))*HP2 +
//   ((R-1)>>1) (R >= 1, which the gate's hr >= 1 guarantees), lanes
//   lext + s;
//   then the v2 tail of obs_tail.cuh with the paired window reads: the G
//   globals and the window candidates, valid when > 0, front-compacted into
//   packed words, and the attempted counts. The window of an agent whose
//   image row is r0 reads half row (r0 & 1) * HP2 + (r0 >> 1) + (u >> 1) of
//   half u & 1 for its row u, on whatever halves it is given: the words
//   equal B1's on the unpaired image where the halves are its pairing.
//
// What bounds it: bytes. The output is E*A*out_w int32 words (100.7 MB per
// step for flagship_v3: 4096 envs x 24 agents x 256), as B1's; the paired
// pool (64 maps x 2 x 64 x 128 words, 4.2 MB) stays in L2. The work per
// byte is a handful of integer operations.
//
// What the design does about it (obs_tail_bulk.cuh, B1's design over
// paired halves): persistent blocks, each walking envs e = blockIdx.x,
// += gridDim.x, and staging each env just before its tail: one thread
// copies its two pooled halves with two 1-D bulk copies (TMA) completing on
// one mbarrier, marked to stay in L2 (every env reads the same pool), and
// every thread copies its agent tables (window corners, agent rows, lanes
// and words, globals) with cp.async. One stage leaves two blocks of 12
// warps per SM at flagship_v3 (91 KB each); two stages left one and were
// slower there. The agents' words are added to both halves with shared
// atomics once the copies have landed. The candidate plan sits in
// registers in its paired form (window row u at half row u >> 1 of half
// u & 1, the right half's distance part of the byte offset), built once per
// block, and each candidate round is branch-free; one bounds test per
// agent picks the unchecked loop (one shared load per candidate). Each warp
// compacts its agent's row in shared memory and one lane stores it with a
// bulk copy, two row buffers per warp. The wrapper picks the warps from
// the shapes and the card's occupancy
// (engine/kernels/tail_plan.py). The TPU kernel's 16-row loads, lane rolls
// and one-hot permute matmul worked around its compiler; here the pairing
// is only an address. No float arithmetic touches a token word.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "obs_tail_bulk.cuh"

namespace {

template <int R, bool kMore>
__global__ void __launch_bounds__(512, 2) obs_tail_static_v3_kernel(
    const int* __restrict__ static_l,  // [P, 2*HP2, WPC]
    const int* __restrict__ static_r,  // [P, 2*HP2, WPC]
    const int* __restrict__ map_idx,   // [E]
    const int* __restrict__ row0,      // [E, A]
    const int* __restrict__ lane0,     // [E, A]
    const int* __restrict__ rext,      // [E, A]
    const int* __restrict__ lext,      // [E, A]
    const int* __restrict__ words,     // [E, A, S]
    const int* __restrict__ gplus,     // [E, A, G]
    const int* __restrict__ geom,      // [K, 3]: (u, v, loc) per window cell
    int* __restrict__ out,             // [E, A, out_w]
    int* __restrict__ attempted,       // [E, A]
    int P, int E, int HP2, int WPC, int A, int S, int G, int K, int out_w) {
  // Shared memory: an mbarrier (128 bytes reserved), the halves
  // [2][2*HP2 * WPC] (left, then right), the agent tables of an env
  // [A * (4 + S + G)] (row0, lane0, rext, lext, words, gplus; padded to 16
  // bytes), then each warp's two row buffers [2][out_w].
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int n_half = 2 * HP2 * WPC;
  const unsigned half_bytes = (unsigned)n_half * 4u;
  const int n_tab = ((A * (4 + S + G)) + 3) & ~3;
  const unsigned mS = tail_bulk::divisor_magic(S);
  int* left = reinterpret_cast<int*>(smem + tail_bulk::kBarrierBytes);
  int* right = left + n_half;
  int* tab = right + n_half;
  const int tid = threadIdx.x;
  int* rows = tab + n_tab + (tid >> 5) * 2 * out_w;

  if (tid == 0) {
    tail_bulk::mbar_init(bar, 1);
    tail_bulk::mbar_fence_init();
  }
  __syncthreads();
  const tail_bulk::SmemPaired read{left, HP2, WPC};
  tail_bulk::Plan<R, kMore> plan;
  plan.build(geom, G, K, S, read.form(), smem);

  const tail_bulk::V2Pack fmt(0);
  unsigned nrow = 0;
  int it = 0;
  for (int e = blockIdx.x; e < E; e += gridDim.x, ++it) {
    // Every thread: the env's agent tables with cp.async; thread 0: its two
    // pooled halves with two bulk copies onto the mbarrier. The previous
    // env's closing __syncthreads ended every read of both. map_idx must
    // lie in [0, P), as the plain version's indexing requires; a value
    // outside fails a device assert, like PyTorch's own index kernels,
    // instead of reading another map.
    const size_t ea0 = (size_t)e * A;
    const tail_bulk::Run runs[6] = {{row0 + ea0, A}, {lane0 + ea0, A}, {rext + ea0, A},
                                    {lext + ea0, A}, {words + ea0 * S, A * S}, {gplus + ea0 * G, A * G}};
    tail_bulk::stage_runs(tab, runs);
    tail_bulk::cp_async_commit();
    if (tid == 0) {
      const int m = map_idx[e];
      if (m < 0 || m >= P) {
        printf("obs_tail_static_v3: map_idx[%d] = %d is outside [0, %d)\n", e, m, P);
        assert(m >= 0 && m < P);
      }
      const uint64_t keep = tail_bulk::policy_keep();
      tail_bulk::fence_proxy_async();
      tail_bulk::mbar_expect_tx(bar, 2u * half_bytes);
      tail_bulk::bulk_copy(left, static_l + (size_t)m * n_half, half_bytes, bar, keep);
      tail_bulk::bulk_copy(right, static_r + (size_t)m * n_half, half_bytes, bar, keep);
    }
    tail_bulk::cp_async_wait_all();
    tail_bulk::mbar_wait(bar, it & 1);
    __syncthreads();

    // ---- add every agent's words once to each half (agents never share a
    // cell; atomics keep the sum the reference computes even if they did) ----
    const int* t_rext = tab + 2 * A;
    const int* t_lext = tab + 3 * A;
    const int* t_words = tab + 4 * A;
    for (int t = tid; t < A * S; t += blockDim.x) {
      const int a = tail_bulk::div_by(t, S, mS);
      const int l = t_lext[a] + (t - a * S);
      if (l < 0 || l >= WPC) continue;
      const int r = t_rext[a];
      const int row_l = (r & 1) * HP2 + (r >> 1);
      const int row_r = (1 - (r & 1)) * HP2 + ((r - 1) >> 1);
      if (row_l >= 0 && row_l < 2 * HP2) atomicAdd(&left[row_l * WPC + l], t_words[t]);
      if (row_r >= 0 && row_r < 2 * HP2) atomicAdd(&right[row_r * WPC + l], t_words[t]);
    }
    __syncthreads();
    tail_bulk::agents_bulk(fmt, plan, read, tab, tab + A, t_words + A * S, out + ea0 * out_w, attempted + ea0, A,
                           G, out_w, rows, nrow);
    __syncthreads();
  }
  if ((tid & 31) == 0) tail_bulk::bulk_wait_all();
}

using KernelFn = void (*)(const int*, const int*, const int*, const int*, const int*, const int*, const int*,
                          const int*, const int*, const int*, int*, int*, int, int, int, int, int, int, int, int,
                          int);

// The dynamic shared memory each instance is allowed, by round count (33:
// the instance with plan entries in shared memory).
int allowed_smem[34] = {};

// The instance for `rounds` candidate rounds (above 32: the one whose plan
// keeps the rounds past 12 in shared memory), with its dynamic shared memory
// allowed up to at least `smem` bytes (raised once per instance and size);
// null for an unknown round count, or for `stages` other than 1.
KernelFn instance(int rounds, int stages, int smem, cudaError_t* err) {
  KernelFn k = nullptr;
  if (stages == 1) {
    switch (rounds) {
      case 4: k = obs_tail_static_v3_kernel<4, false>; break;
      case 8: k = obs_tail_static_v3_kernel<8, false>; break;
      case 12: k = obs_tail_static_v3_kernel<12, false>; break;
      case 16: k = obs_tail_static_v3_kernel<16, false>; break;
      case 24: k = obs_tail_static_v3_kernel<24, false>; break;
      case 32: k = obs_tail_static_v3_kernel<32, false>; break;
      default: k = rounds > 32 ? obs_tail_static_v3_kernel<12, true> : nullptr; break;
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
extern "C" int obs_tail_static_v3_occupancy(int rounds, int stages, int warps, int smem, int* out) {
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
extern "C" int obs_tail_static_v3_launch(
    const void* static_l, const void* static_r, const void* map_idx, const void* row0, const void* lane0,
    const void* rext, const void* lext, const void* words, const void* gplus, const void* geom,
    void* out, void* attempted, int P, int HP2, int WPC, int E, int A, int S, int G, int K, int out_w,
    int rounds, int stages, int warps, int grid, int smem, void* stream) {
  cudaError_t err;
  KernelFn k = instance(rounds, stages, smem, &err);
  if (err != cudaSuccess) return (int)err;
  k<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int*)static_l, (const int*)static_r, (const int*)map_idx, (const int*)row0, (const int*)lane0,
      (const int*)rext, (const int*)lext, (const int*)words, (const int*)gplus, (const int*)geom,
      (int*)out, (int*)attempted, P, E, HP2, WPC, A, S, G, K, out_w);
  return (int)cudaGetLastError();
}
