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
// What the design does about it: one block per env builds its image in
// shared memory (48 KB at general shapes): zero it, then scatter the N*S
// object words with shared atomics, so the image never touches device
// memory; every window read then hits shared memory, and the tail writes
// every output word once, coalesced by lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_tail.cuh"

namespace {

__global__ void obs_tail_dynobj_v2_kernel(
    const int* __restrict__ rext,   // [E, N] image row of each object
    const int* __restrict__ lext,   // [E, N] image lane of each object's first word
    const int* __restrict__ words,  // [E, N, S] +1-encoded object words (0 = none)
    const int* __restrict__ row0,   // [E, A]
    const int* __restrict__ lane0,  // [E, A]
    const int* __restrict__ gplus,  // [E, A, G]
    const int* __restrict__ geom,   // [K, 3]: (u, v, loc) per window cell
    int* __restrict__ out,          // [E, A, out_w]
    int* __restrict__ attempted,    // [E, A]
    int HP, int WPC, int N, int A, int S, int G, int K, int out_w, int wide) {
  extern __shared__ int smem[];
  const int n_img = HP * WPC;
  int* img = smem;           // [HP * WPC]
  int* tab = img + n_img;    // [3 * K * S] candidate tables
  const int e = blockIdx.x;
  const int tid = threadIdx.x;

  // ---- zero the image (16-byte stores; HP*WPC % 4 == 0) ----
  int4* dst = reinterpret_cast<int4*>(img);
  for (int i = tid; i < n_img / 4; i += blockDim.x) dst[i] = make_int4(0, 0, 0, 0);
  obs_tail::load_tables(geom, K, S, tab);
  __syncthreads();

  // ---- add every object's words (neighbouring threads read neighbouring
  // words; objects never share a live cell, atomics keep the sum anyway) ----
  const size_t en0 = (size_t)e * N;
  for (int t = tid; t < N * S; t += blockDim.x) {
    const int w = words[en0 * S + t];
    if (w == 0) continue;
    const int n = t / S;
    const int s = t - n * S;
    const int r = rext[en0 + n];
    const int l = lext[en0 + n] + s;
    if (r >= 0 && r < HP && l >= 0 && l < WPC) atomicAdd(&img[r * WPC + l], w);
  }
  __syncthreads();

  obs_tail::agents(obs_tail::V2Words(wide), img, tab, HP, WPC, K * S, row0, lane0, gplus, out,
                   attempted, e, A, G, out_w);
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
extern "C" int obs_tail_dynobj_v2_launch(
    const void* rext, const void* lext, const void* words, const void* row0, const void* lane0,
    const void* gplus, const void* geom, void* out, void* attempted, int HP, int WPC, int E,
    int N, int A, int S, int G, int K, int out_w, int wide, void* stream) {
  const int smem = obs_tail::smem_bytes(HP, WPC, K, S);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        obs_tail_dynobj_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  obs_tail_dynobj_v2_kernel<<<E, obs_tail::block_threads(A), smem, (cudaStream_t)stream>>>(
      (const int*)rext, (const int*)lext, (const int*)words, (const int*)row0, (const int*)lane0,
      (const int*)gplus, (const int*)geom, (int*)out, (int*)attempted, HP, WPC, N, A, S, G, K,
      out_w, wide);
  return (int)cudaGetLastError();
}
