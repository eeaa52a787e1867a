// The v1 observation tail for static-background configs, written for Hopper
// (sm_90a).
//
// Replaces: obs_tail_static_pallas, mettagrid_tpu/engine/pallas_kernels.py:1374
// (kernel B4).
//
// What it computes, per env e and agent a:
//   img   = static_imgp[map_idx[e]]  (+1-encoded token words, 0 = empty),
//           plus every agent's S words added at (rext, lext + s);
//   then the v1 tail of obs_tail.cuh: GP globals that may be absent,
//   then the window candidates in Manhattan order, valid when > 0, written
//   as (cell - 1) | loc << 16 and front-compacted into t_pad words (-1
//   fill), and the attempted counts.
//
// What bounds it: bytes. At the arena_lp shapes (4096 envs x 24 agents,
// S = 3, t_pad = 389) the output words are 153 MB; the inputs are a few MB
// and the static pool (1.5 MB) stays in L2. The work per byte is a handful
// of integer operations.
//
// What the design does about it: B1's. One block per env stages that env's
// image in shared memory (one read of the pooled image from L2, agents added
// with shared atomics), every window read hits shared memory, and the tail
// writes every output word once, coalesced by lane. No float arithmetic
// touches a word (the TPU kernel placed the agents with an f32 matmul at
// HIGHEST precision and permuted windows through int8 byte planes).

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "obs_tail.cuh"

namespace {

__global__ void obs_tail_static_v1_kernel(
    const int* __restrict__ static_imgp,  // [P, HP, WPC]
    const int* __restrict__ map_idx,      // [E]
    const int* __restrict__ row0,         // [E, A]
    const int* __restrict__ lane0,        // [E, A]
    const int* __restrict__ rext,         // [E, A]
    const int* __restrict__ lext,         // [E, A]
    const int* __restrict__ words,        // [E, A, S]
    const int* __restrict__ gwords,       // [E, A, GP]
    const int* __restrict__ geom,         // [K, 3]: (u, v, loc) per window cell
    int* __restrict__ out,                // [E, A, t_pad]
    int* __restrict__ attempted,          // [E, A]
    int P, int HP, int WPC, int A, int S, int GP, int K, int t_pad) {
  extern __shared__ int smem[];
  const int n_img = HP * WPC;
  int* img = smem;           // [HP * WPC]
  int* tab = img + n_img;    // [3 * K * S] candidate tables
  const int e = blockIdx.x;
  const int tid = threadIdx.x;

  // ---- stage this env's static image (16-byte loads; HP*WPC % 4 == 0);
  // a map_idx outside [0, P) fails a device assert, as in B1 ----
  const int m = map_idx[e];
  if (m < 0 || m >= P) {
    if (tid == 0) printf("obs_tail_static_v1: map_idx[%d] = %d is outside [0, %d)\n", e, m, P);
    assert(m >= 0 && m < P);
  }
  const int4* src = reinterpret_cast<const int4*>(static_imgp + (size_t)m * n_img);
  int4* dst = reinterpret_cast<int4*>(img);
  for (int i = tid; i < n_img / 4; i += blockDim.x) dst[i] = src[i];
  obs_tail::load_tables(geom, K, S, tab);
  __syncthreads();

  // ---- add the agents' words (shared atomics: the sum the reference takes) ----
  const size_t ea0 = (size_t)e * A;
  for (int t = tid; t < A * S; t += blockDim.x) {
    const int a = t / S;
    const int s = t - a * S;
    const int r = rext[ea0 + a];
    const int l = lext[ea0 + a] + s;
    if (r >= 0 && r < HP && l >= 0 && l < WPC) atomicAdd(&img[r * WPC + l], words[(ea0 + a) * S + s]);
  }
  __syncthreads();

  obs_tail::agents(img, tab, HP, WPC, K * S, row0, lane0, gwords, out, attempted, e, A, GP, t_pad);
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
extern "C" int obs_tail_static_v1_launch(
    const void* static_imgp, const void* map_idx, const void* row0, const void* lane0,
    const void* rext, const void* lext, const void* words, const void* gwords, const void* geom,
    void* out, void* attempted, int P, int HP, int WPC, int E, int A, int S, int GP, int K,
    int t_pad, void* stream) {
  const int smem = obs_tail::smem_bytes(HP, WPC, K, S);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        obs_tail_static_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  obs_tail_static_v1_kernel<<<E, obs_tail::block_threads(A), smem, (cudaStream_t)stream>>>(
      (const int*)static_imgp, (const int*)map_idx, (const int*)row0, (const int*)lane0,
      (const int*)rext, (const int*)lext, (const int*)words, (const int*)gwords, (const int*)geom,
      (int*)out, (int*)attempted, P, HP, WPC, A, S, GP, K, t_pad);
  return (int)cudaGetLastError();
}
