// The v1 observation tail for static-background configs, written for Hopper
// (sm_90a).
//
// Replaces: obs_tail_static_pallas, mettagrid_tpu/engine/pallas_kernels.py:1374
// (kernel B4).
//
// What it computes, per env e and agent a:
//   img   = static_imgp[map_idx[e]]  (+1-encoded token words, 0 = empty),
//           plus every agent's S words added at (rext, lext + s);
//   then the v1 tail of obs_tail.cuh: GP globals that may be absent (0 reads
//   as invalid), then the window candidates in Manhattan order, valid when
//   > 0, written as (cell - 1) | loc << 16 and front-compacted into t_pad
//   words (-1 fill), and the attempted counts.
//
// What bounds it: bytes. At the arena_lp shapes (4096 envs x 24 agents,
// image 48 x 128, GP 5, K 121, S 3: 368 candidates, 12 rounds; t_pad = 389)
// the output words are 153 MB; the inputs are a few MB and the static pool
// (1.5 MB) stays in L2. The work per byte is a handful of integer
// operations, so the kernel must keep the stores flowing and spend few
// instructions per candidate.
//
// What the design does about it: B1's (obs_tail_static_v2.cu), whose body
// it shares (obs_tail_bulk.cuh, static_envs) in the v1 words (V1WholeRows).
// Persistent blocks walk the envs; each env's pooled map arrives by one bulk
// copy (TMA) onto an mbarrier, kept in L2, and its agent tables by
// cp.async, just before its tail (one stage: two, the env ahead staged
// while the current one runs, lost at every warp count measured, and their
// instances spilled at 32 rounds); the agents' words are added with shared
// atomics; the candidate plan sits
// in registers, built once per block, so each candidate round is a shared
// load, a ballot and a shared store, with one bounds test per agent; each
// warp compacts its agent's row in shared memory and one lane stores it by
// bulk copy while the warp compacts the next. Two things differ from B1:
// - globals may be absent and may number more than 32 (value observations:
//   the flagship with every resource's amount in base 10 has 53). Up to 32
//   share the first round with the window, as in B1; past 32 they take
//   rounds of their own, read from the staged agent table, and the plan
//   holds the window candidates alone (kGlobalRounds);
// - v1 rows have any width (GP + 128 k words): the wrapper lays the rows
//   out at a pitch rounded up to whole 16-byte units, passed here as t_pad,
//   and returns the first GP + 128 k words of each, so every row is
//   bulk-stored. (Rows at the exact pitch, copied out by the warp as B5
//   copies its rows, took 17-20% longer at arena_lp on the H100.)
// The wrapper picks the warps from the shapes and the card's occupancy
// (engine/kernels/tail_plan.py). No float arithmetic touches a
// word (the TPU kernel placed the agents with an f32 matmul at HIGHEST
// precision and permuted windows through int8 byte planes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_tail_bulk.cuh"

namespace {

template <int R, bool kMore>
__global__ void __launch_bounds__(512, 2) obs_tail_static_v1_kernel(
    const int* __restrict__ static_imgp,  // [P, HP, WPC]
    const int* __restrict__ map_idx,      // [E]
    const int* __restrict__ row0,         // [E, A]
    const int* __restrict__ lane0,        // [E, A]
    const int* __restrict__ rext,         // [E, A]
    const int* __restrict__ lext,         // [E, A]
    const int* __restrict__ words,        // [E, A, S]
    const int* __restrict__ gwords,       // [E, A, GP]
    const int* __restrict__ geom,         // [K, 3]: (u, v, loc) per window cell
    int* __restrict__ out,                // [E, A, t_pad], t_pad % 4 == 0
    int* __restrict__ attempted,          // [E, A]
    int P, int E, int HP, int WPC, int A, int S, int GP, int K, int t_pad) {
  // Shared memory: tail_bulk::static_envs's layout.
  extern __shared__ __align__(128) unsigned char smem[];
  tail_bulk::static_envs<R, 1, kMore, true, tail_bulk::V1WholeRows>(
      0, static_imgp, map_idx, row0, lane0, rext, lext, words, gwords, geom, out, attempted, P, E, HP, WPC, A, S, GP,
      K, t_pad, smem);
}

using KernelFn = void (*)(const int*, const int*, const int*, const int*, const int*, const int*, const int*,
                          const int*, const int*, int*, int*, int, int, int, int, int, int, int, int, int);

// The dynamic shared memory each instance is allowed, by round count (33:
// the instance with plan entries in shared memory).
int allowed_smem[34] = {};

KernelFn pick_rounds(int rounds) {
  switch (rounds) {
    case 4: return obs_tail_static_v1_kernel<4, false>;
    case 8: return obs_tail_static_v1_kernel<8, false>;
    case 12: return obs_tail_static_v1_kernel<12, false>;
    case 16: return obs_tail_static_v1_kernel<16, false>;
    case 24: return obs_tail_static_v1_kernel<24, false>;
    case 32: return obs_tail_static_v1_kernel<32, false>;
    default: return rounds > 32 ? obs_tail_static_v1_kernel<12, true> : nullptr;
  }
}

// The instance for `rounds` candidate rounds (above 32: the one whose plan
// keeps the rounds past 12 in shared memory) and `stages` pipeline stages
// (one), with its dynamic shared memory allowed up to at least `smem` bytes
// (raised once per instance and size); null for an unknown combination.
KernelFn instance(int rounds, int stages, int smem, cudaError_t* err) {
  KernelFn k = stages == 1 ? pick_rounds(rounds) : nullptr;
  int* allowed = &allowed_smem[rounds > 32 ? 33 : rounds];
  *err = k == nullptr ? cudaErrorInvalidValue : tail_bulk::allow_smem((const void*)k, smem, allowed);
  return k;
}

}  // namespace

// Blocks per SM (out[0]) and registers per thread (out[1]) of the instance
// at `warps` warps per block and `smem` bytes of dynamic shared memory;
// returns the cudaError_t.
extern "C" int obs_tail_static_v1_occupancy(int rounds, int stages, int warps, int smem, int* out) {
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
extern "C" int obs_tail_static_v1_launch(
    const void* static_imgp, const void* map_idx, const void* row0, const void* lane0,
    const void* rext, const void* lext, const void* words, const void* gwords, const void* geom,
    void* out, void* attempted, int P, int HP, int WPC, int E, int A, int S, int GP, int K,
    int t_pad, int rounds, int stages, int warps, int grid, int smem, void* stream) {
  cudaError_t err;
  KernelFn k = instance(rounds, stages, smem, &err);
  if (err != cudaSuccess) return (int)err;
  k<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int*)static_imgp, (const int*)map_idx, (const int*)row0, (const int*)lane0,
      (const int*)rext, (const int*)lext, (const int*)words, (const int*)gwords, (const int*)geom,
      (int*)out, (int*)attempted, P, E, HP, WPC, A, S, GP, K, t_pad);
  return (int)cudaGetLastError();
}
