// Fused observation tail for static-background configs, written for Hopper
// (sm_90a).
//
// Replaces: obs_tail_static_v2_pallas, mettagrid_tpu/engine/pallas_kernels.py:594
// (kernel B1), with normal (`wide` = 0) and wide (`wide` = 1) word packing.
//
// What it computes, per env e and agent a:
//   img   = static_imgp[map_idx[e]]  (+1-encoded token words, 0 = empty),
//           plus every agent's S words added at (rext, lext + s);
//   then the v2 tail of obs_tail.cuh: the G globals and the window
//   candidates, valid when > 0, front-compacted into packed words, and the
//   attempted counts.
//
// What bounds it: bytes. The output is E*A*out_w int32 words (100.7 MB per
// step for the flagship arena: 4096 envs x 24 agents x 256); the inputs are a
// few MB, and the static pool (1.5 MB) stays in L2. The work per byte is a
// handful of integer operations, so the kernel must keep the stores flowing
// and spend few instructions per candidate.
//
// What the design does about it (obs_tail_bulk.cuh, static_envs, whose body
// B4 shares in the v1 words): persistent blocks, each
// walking envs e = blockIdx.x, += gridDim.x. With kStages > 1 a block stages
// the env kStages - 1 ahead while it runs the current one: one thread copies
// its pooled image with a 1-D bulk copy (TMA) completing on that stage's
// mbarrier, and every thread copies its agent tables (window corners, agent
// positions and words, globals) with cp.async; with one stage the block
// stages each env just before its tail. The agents' words are added with
// shared atomics once the copies have landed. The candidate plan sits in
// registers, built once per block, and each candidate round is branch-free;
// one bounds test per agent picks the unchecked loop (one shared load per
// candidate) wherever the window lies inside the padded image, which is
// every live agent of the bench maps. Each warp compacts its agent's row in
// shared memory and one lane stores it with a bulk copy, two row buffers per
// warp, so stores overlap compaction. The pool is marked to stay in L2, the
// rows to leave it first. The wrapper picks the stages and warps from the
// shapes and the card's occupancy (engine/kernels/tail_plan.py). No float
// arithmetic touches a token word.

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_tail_bulk.cuh"

namespace {

template <int R, int kStages, bool kMore>
__global__ void __launch_bounds__(512, 2) obs_tail_static_v2_kernel(
    const int* __restrict__ static_imgp,  // [P, HP, WPC]
    const int* __restrict__ map_idx,      // [E]
    const int* __restrict__ row0,         // [E, A]
    const int* __restrict__ lane0,        // [E, A]
    const int* __restrict__ rext,         // [E, A]
    const int* __restrict__ lext,         // [E, A]
    const int* __restrict__ words,        // [E, A, S]
    const int* __restrict__ gplus,        // [E, A, G]
    const int* __restrict__ geom,         // [K, 3]: (u, v, loc) per window cell
    int* __restrict__ out,                // [E, A, out_w]
    int* __restrict__ attempted,          // [E, A]
    int P, int E, int HP, int WPC, int A, int S, int G, int K, int out_w, int wide) {
  // Shared memory: tail_bulk::static_envs's layout.
  extern __shared__ __align__(128) unsigned char smem[];
  tail_bulk::static_envs<R, kStages, kMore, false, tail_bulk::V2Pack>(wide, static_imgp, map_idx, row0, lane0, rext,
                                                   lext, words, gplus, geom, out, attempted, P, E, HP, WPC, A, S, G,
                                                   K, out_w, smem);
}

using KernelFn = void (*)(const int*, const int*, const int*, const int*, const int*, const int*, const int*,
                          const int*, const int*, int*, int*, int, int, int, int, int, int, int, int, int, int);

// The dynamic shared memory each instance is allowed, by stage count and
// round count (33: the instance with plan entries in shared memory).
int allowed_smem[3][34] = {};

template <int kStages>
KernelFn pick_rounds(int rounds) {
  switch (rounds) {
    case 4: return obs_tail_static_v2_kernel<4, kStages, false>;
    case 8: return obs_tail_static_v2_kernel<8, kStages, false>;
    case 12: return obs_tail_static_v2_kernel<12, kStages, false>;
    case 16: return obs_tail_static_v2_kernel<16, kStages, false>;
    case 24: return obs_tail_static_v2_kernel<24, kStages, false>;
    case 32: return obs_tail_static_v2_kernel<32, kStages, false>;
    default: return rounds > 32 ? obs_tail_static_v2_kernel<12, kStages, true> : nullptr;
  }
}

// The instance for `rounds` candidate rounds (above 32: the one whose plan
// keeps the rounds past 12 in shared memory) and `stages` pipeline stages,
// with its dynamic shared memory allowed up to at least `smem` bytes
// (raised once per instance and size); null for an unknown combination.
KernelFn instance(int rounds, int stages, int smem, cudaError_t* err) {
  KernelFn k = stages == 1 ? pick_rounds<1>(rounds) : stages == 2 ? pick_rounds<2>(rounds) : nullptr;
  int* allowed = &allowed_smem[stages][rounds > 32 ? 33 : rounds];
  *err = k == nullptr ? cudaErrorInvalidValue : tail_bulk::allow_smem((const void*)k, smem, allowed);
  return k;
}

}  // namespace

// Blocks per SM (out[0]) and registers per thread (out[1]) of the instance
// at `warps` warps per block and `smem` bytes of dynamic shared memory;
// returns the cudaError_t.
extern "C" int obs_tail_static_v2_occupancy(int rounds, int stages, int warps, int smem, int* out) {
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
extern "C" int obs_tail_static_v2_launch(
    const void* static_imgp, const void* map_idx, const void* row0, const void* lane0,
    const void* rext, const void* lext, const void* words, const void* gplus, const void* geom,
    void* out, void* attempted, int P, int HP, int WPC, int E, int A, int S, int G, int K,
    int out_w, int wide, int rounds, int stages, int warps, int grid, int smem, void* stream) {
  cudaError_t err;
  KernelFn k = instance(rounds, stages, smem, &err);
  if (err != cudaSuccess) return (int)err;
  k<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int*)static_imgp, (const int*)map_idx, (const int*)row0, (const int*)lane0,
      (const int*)rext, (const int*)lext, (const int*)words, (const int*)gplus, (const int*)geom,
      (int*)out, (int*)attempted, P, E, HP, WPC, A, S, G, K, out_w, wide);
  return (int)cudaGetLastError();
}
