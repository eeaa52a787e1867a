// Fused observation tail for mutable-background configs, with each env's
// image built from the object tables, written for Hopper (sm_90a).
//
// Replaces: obs_tail_dynobj_v2_pallas, mettagrid_tpu/engine/pallas_kernels.py:1104
// (kernel B2), with normal (`wide` = 0) and wide (`wide` = 1) word packing.
//
// What it computes, per env e and agent a:
//   img   = int32 [HP, WPC], zero except that every object n adds its S words
//           words[e, n, s] at (rext[e, n], lext[e, n] + s); positions outside
//           the image add nothing, and dead objects carry zero words whatever
//           their stale coordinates;
//   then the v2 tail of obs_tail.cuh (B1's): the G globals and the
//   window candidates, valid when > 0, front-compacted into packed words,
//   and the attempted counts.
// The TPU kernel sums the words into the image through an exact one-hot
// matmul, so two words on one cell add; integer shared-memory atomics give
// the same sum. No float arithmetic touches a token word.
//
// What bounds it: bytes. At the general flagship shapes (4096 envs x 24
// agents, N = 130 objects, S = 6, out_w = 512) the output words are 201 MB
// and the inputs 19 MB (the object words 12.8 MB of them); the work per byte
// is a few integer operations.
//
// What the design does about it (obs_tail_bulk.cuh): persistent blocks, each
// walking envs e = blockIdx.x, += gridDim.x over one image buffer in shared
// memory (48 KB at general shapes), zeroed once per block; after an env's
// tail the block writes 0 back at exactly the N*S cells it scattered into
// (about 780 words) instead of zeroing the whole image per env. With
// kStages > 1 the tables of the env kStages - 1 ahead (rext, lext, words,
// and the agents' window corners and globals) are prefetched into a shared
// staging area with 4-byte cp.async while the current env's tail runs (N*4
// bytes need not be a multiple of 16, and the wrapper never pads or copies
// its inputs); with one stage they are read from device memory. The
// candidate plan sits in registers, built once per block, and each candidate
// round is branch-free; one bounds test per agent picks the unchecked loop;
// each warp compacts its agent's row in shared memory and one lane stores it
// with a bulk copy, two row buffers per warp, marked to leave L2 first. The
// wrapper picks the stages and warps from the shapes and the card's
// occupancy (engine/kernels/tail_plan.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_tail_bulk.cuh"

namespace {

template <int R, int kStages, bool kMore>
__global__ void __launch_bounds__(512, 2) obs_tail_dynobj_v2_kernel(
    const int* __restrict__ rext,   // [E, N] image row of each object
    const int* __restrict__ lext,   // [E, N] image lane of each object's first word
    const int* __restrict__ words,  // [E, N, S] +1-encoded object words (0 = none)
    const int* __restrict__ row0,   // [E, A]
    const int* __restrict__ lane0,  // [E, A]
    const int* __restrict__ gplus,  // [E, A, G]
    const int* __restrict__ geom,   // [K, 3]: (u, v, loc) per window cell
    int* __restrict__ out,          // [E, A, out_w]
    int* __restrict__ attempted,    // [E, A]
    int E, int HP, int WPC, int N, int A, int S, int G, int K, int out_w, int wide) {
  // Shared memory: the image [HP * WPC], each warp's two row buffers
  // [2][out_w], then (kStages > 1) a staging area per stage of an env's
  // tables [kStages][N * (2 + S) + A * (2 + G)] (rext, lext, words, row0,
  // lane0, gplus; padded to 16 bytes). With one stage the tables are read
  // from device memory.
  extern __shared__ __align__(128) unsigned char smem[];
  int* img = reinterpret_cast<int*>(smem);
  const int n_img = HP * WPC;
  const int tid = threadIdx.x;
  const int nwarps = blockDim.x >> 5;
  int* rows = img + n_img + (tid >> 5) * 2 * out_w;
  int* stage = img + n_img + nwarps * 2 * out_w;
  const int NS = N * S;
  const unsigned mS = tail_bulk::divisor_magic(S);
  const int n_tab = (N * (2 + S) + A * (2 + G) + 3) & ~3;

  // ---- zero the image once (16-byte stores; HP*WPC % 4 == 0) ----
  int4* dst = reinterpret_cast<int4*>(img);
  for (int i = tid; i < n_img / 4; i += blockDim.x) dst[i] = make_int4(0, 0, 0, 0);
  tail_bulk::Plan<R, kMore> plan;
  plan.build(geom, G, K, S, WPC, smem);

  // Every thread: its share of env `env`'s tables into stage s (one group).
  auto prefetch = [&](int env, int s) {
    const size_t en0 = (size_t)env * N, ea0 = (size_t)env * A;
    const tail_bulk::Run runs[6] = {{rext + en0, N}, {lext + en0, N}, {words + en0 * S, NS},
                                    {row0 + ea0, A}, {lane0 + ea0, A}, {gplus + ea0 * G, A * G}};
    tail_bulk::stage_runs(stage + s * n_tab, runs);
    tail_bulk::cp_async_commit();
  };
  // The first kStages - 1 envs of this block, ahead of the loop.
  for (int i = 0; i + 1 < kStages; ++i) {
    if ((int)blockIdx.x + i * (int)gridDim.x < E) prefetch(blockIdx.x + i * gridDim.x, i);
  }

  const tail_bulk::V2Pack fmt(wide);
  unsigned nrow = 0;
  int it = 0;
  for (int e = blockIdx.x; e < E; e += gridDim.x, ++it) {
    const size_t en0 = (size_t)e * N, ea0 = (size_t)e * A;
    const int* t_r = rext + en0;
    const int* t_l = lext + en0;
    const int* t_w = words + en0 * S;
    const int* t_row0 = row0 + ea0;
    const int* t_lane0 = lane0 + ea0;
    const int* t_gplus = gplus + ea0 * G;
    if (kStages > 1) {
      const int* st = stage + (it % kStages) * n_tab;
      t_r = st;
      t_l = st + N;
      t_w = st + 2 * N;
      t_row0 = t_w + NS;
      t_lane0 = t_row0 + A;
      t_gplus = t_lane0 + A;
      // This env's group is the oldest pending one but for the kStages - 2
      // staged after it, where they exist.
      if (e + (kStages - 2) * (int)gridDim.x < E) {
        tail_bulk::cp_async_wait<(kStages > 1 ? kStages - 2 : 0)>();
      } else {
        tail_bulk::cp_async_wait_all();
      }
    }
    // Orders the previous env's clearing before this env's scatter, and
    // makes every thread's staged tables visible.
    __syncthreads();
    // The stage kStages - 1 envs ahead was last read before this
    // __syncthreads.
    const int e_ahead = e + (kStages - 1) * gridDim.x;
    if (kStages > 1 && e_ahead < E) prefetch(e_ahead, (it + kStages - 1) % kStages);

    // ---- add every object's words (objects never share a live cell,
    // atomics keep the sum anyway) ----
    for (int t = tid; t < NS; t += blockDim.x) {
      const int w = t_w[t];
      if (w == 0) continue;
      const int n = tail_bulk::div_by(t, S, mS);
      const int r = t_r[n];
      const int l = t_l[n] + (t - n * S);
      if (r >= 0 && r < HP && l >= 0 && l < WPC) atomicAdd(&img[r * WPC + l], w);
    }
    __syncthreads();
    tail_bulk::agents_bulk(fmt, plan, tail_bulk::SmemFlat{img, HP, WPC}, t_row0, t_lane0, t_gplus,
                           out + ea0 * out_w, attempted + ea0, A, G, out_w, rows, nrow);
    __syncthreads();

    // ---- write 0 back at exactly the cells this env scattered into: exact
    // whatever the duplicates, since every cell started at 0 ----
    for (int t = tid; t < NS; t += blockDim.x) {
      if (t_w[t] == 0) continue;
      const int n = tail_bulk::div_by(t, S, mS);
      const int r = t_r[n];
      const int l = t_l[n] + (t - n * S);
      if (r >= 0 && r < HP && l >= 0 && l < WPC) img[r * WPC + l] = 0;
    }
  }
  if ((tid & 31) == 0) tail_bulk::bulk_wait_all();
}

using KernelFn = void (*)(const int*, const int*, const int*, const int*, const int*, const int*, const int*,
                          int*, int*, int, int, int, int, int, int, int, int, int, int);

// The dynamic shared memory each instance is allowed, by stage count and
// round count (33: the instance with plan entries in shared memory).
int allowed_smem[3][34] = {};

template <int kStages>
KernelFn pick_rounds(int rounds) {
  switch (rounds) {
    case 4: return obs_tail_dynobj_v2_kernel<4, kStages, false>;
    case 8: return obs_tail_dynobj_v2_kernel<8, kStages, false>;
    case 12: return obs_tail_dynobj_v2_kernel<12, kStages, false>;
    case 16: return obs_tail_dynobj_v2_kernel<16, kStages, false>;
    case 24: return obs_tail_dynobj_v2_kernel<24, kStages, false>;
    case 32: return obs_tail_dynobj_v2_kernel<32, kStages, false>;
    default: return rounds > 32 ? obs_tail_dynobj_v2_kernel<12, kStages, true> : nullptr;
  }
}

// The instance for `rounds` candidate rounds (above 32: the one whose plan
// keeps the rounds past 12 in shared memory) and `stages` staging areas
// (1: none), with its dynamic shared memory allowed up to at least `smem`
// bytes; null for an unknown combination.
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
extern "C" int obs_tail_dynobj_v2_occupancy(int rounds, int stages, int warps, int smem, int* out) {
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
extern "C" int obs_tail_dynobj_v2_launch(
    const void* rext, const void* lext, const void* words, const void* row0, const void* lane0,
    const void* gplus, const void* geom, void* out, void* attempted, int HP, int WPC, int E,
    int N, int A, int S, int G, int K, int out_w, int wide, int rounds, int stages, int warps, int grid,
    int smem, void* stream) {
  cudaError_t err;
  KernelFn k = instance(rounds, stages, smem, &err);
  if (err != cudaSuccess) return (int)err;
  k<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int*)rext, (const int*)lext, (const int*)words, (const int*)row0, (const int*)lane0,
      (const int*)gplus, (const int*)geom, (int*)out, (int*)attempted, E, HP, WPC, N, A, S, G, K, out_w, wide);
  return (int)cudaGetLastError();
}
