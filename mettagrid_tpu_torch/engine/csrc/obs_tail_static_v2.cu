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
// What the design does about it (obs_tail_bulk.cuh): persistent blocks, each
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

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

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
  // Shared memory: an mbarrier per stage (128 bytes reserved), the image
  // buffers [kStages][HP * WPC], the agent tables of an env
  // [kStages][A * (4 + S + G)] (row0, lane0, rext, lext, words, gplus;
  // padded to 16 bytes), then each warp's two row buffers [2][out_w].
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int n_img = HP * WPC;
  const unsigned img_bytes = (unsigned)n_img * 4u;
  const int n_tab = ((A * (4 + S + G)) + 3) & ~3;
  const unsigned mS = tail_bulk::divisor_magic(S);
  int* imgs = reinterpret_cast<int*>(smem + 128);
  int* tabs = imgs + kStages * n_img;
  const int tid = threadIdx.x;
  int* rows = tabs + kStages * n_tab + (tid >> 5) * 2 * out_w;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) tail_bulk::mbar_init(&bar[s], 1);
    tail_bulk::mbar_fence_init();
  }
  __syncthreads();
  tail_bulk::Plan<R, kMore> plan;
  plan.build(geom, G, K, S, WPC, smem);

  // Every thread: env `env`'s agent tables into stage s with cp.async (one
  // group); thread 0: its pooled image with a bulk copy onto bar[s].
  // map_idx must lie in [0, P), as the plain version's indexing requires; a
  // value outside fails a device assert, like PyTorch's own index kernels,
  // instead of reading another map.
  auto stage = [&](int env, int s) {
    const size_t ea0 = (size_t)env * A;
    const tail_bulk::Run runs[6] = {{row0 + ea0, A}, {lane0 + ea0, A}, {rext + ea0, A},
                                    {lext + ea0, A}, {words + ea0 * S, A * S}, {gplus + ea0 * G, A * G}};
    tail_bulk::stage_runs(tabs + s * n_tab, runs);
    tail_bulk::cp_async_commit();
    if (tid == 0) {
      const int m = map_idx[env];
      if (m < 0 || m >= P) {
        printf("obs_tail_static_v2: map_idx[%d] = %d is outside [0, %d)\n", env, m, P);
        assert(m >= 0 && m < P);
      }
      tail_bulk::fence_proxy_async();
      tail_bulk::bulk_load(imgs + s * n_img, static_imgp + (size_t)m * n_img, img_bytes, &bar[s]);
    }
  };
  // The first kStages - 1 envs of this block, ahead of the loop.
  for (int i = 0; i + 1 < kStages; ++i) {
    if ((int)blockIdx.x + i * (int)gridDim.x < E) stage(blockIdx.x + i * gridDim.x, i);
  }

  const tail_bulk::V2Pack fmt(wide);
  unsigned nrow = 0;
  int it = 0;
  for (int e = blockIdx.x; e < E; e += gridDim.x, ++it) {
    const int s = it % kStages;
    // The stage kStages - 1 envs ahead was last read before the previous
    // env's closing __syncthreads: stage that env there now, then wait for
    // this one (with one stage, stage it now and wait).
    const int e_ahead = e + (kStages - 1) * gridDim.x;
    if (e_ahead < E) {
      stage(e_ahead, (it + kStages - 1) % kStages);
      tail_bulk::cp_async_wait<kStages - 1>();
    } else {
      tail_bulk::cp_async_wait_all();
    }
    int* img = imgs + s * n_img;
    const int* tab = tabs + s * n_tab;
    tail_bulk::mbar_wait(&bar[s], (it / kStages) & 1);
    __syncthreads();

    // ---- add the agents' words (agents never share a cell; atomics keep
    // the sum the reference computes even if they did) ----
    const int* t_rext = tab + 2 * A;
    const int* t_lext = tab + 3 * A;
    const int* t_words = tab + 4 * A;
    for (int t = tid; t < A * S; t += blockDim.x) {
      const int a = tail_bulk::div_by(t, S, mS);
      const int r = t_rext[a];
      const int l = t_lext[a] + (t - a * S);
      if (r >= 0 && r < HP && l >= 0 && l < WPC) atomicAdd(&img[r * WPC + l], t_words[t]);
    }
    __syncthreads();
    const size_t ea0 = (size_t)e * A;
    tail_bulk::agents_bulk(fmt, plan, tail_bulk::SmemFlat{img, HP, WPC}, tab, tab + A, t_words + A * S,
                           out + ea0 * out_w, attempted + ea0, A, G, out_w, rows, nrow);
    __syncthreads();
  }
  if ((tid & 31) == 0) tail_bulk::bulk_wait_all();
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
