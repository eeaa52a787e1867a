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
// It serves the maps whose image B1 or B2 cannot stage: one env's image plus
// the tables above the 232,448 bytes of shared memory a block may use (the
// 128x128 arena: 144 x 512 words, 295 KB).
//
// What bounds it: bytes. At the arena_128 shapes (4096 envs x 24 agents,
// S = 3, out_w = 256) the output words are 101 MB; of the 1.2 GB image it
// needs only the words inside some agent's window (about a quarter on a
// 128x128 map with 24 agents). The work per byte is a few integer
// operations.
//
// What the design does about it: each warp reads its agent's window cells
// straight from device memory (windows cross lane tiles freely: a lane is
// just an offset), so the image is read only where a window lies, and the
// tail writes every output word once. The candidate tables sit in shared
// memory. No float arithmetic touches a word.

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_tail.cuh"

namespace {

__global__ void obs_tail_dyn_v2_kernel(
    const int* __restrict__ imgp,   // [E, HP, WPC]
    const int* __restrict__ row0,   // [E, A]
    const int* __restrict__ lane0,  // [E, A]
    const int* __restrict__ gplus,  // [E, A, G]
    const int* __restrict__ geom,   // [K, 3]: (u, v, loc) per window cell
    int* __restrict__ out,          // [E, A, out_w]
    int* __restrict__ attempted,    // [E, A]
    int HP, int WPC, int A, int S, int G, int K, int out_w, int wide) {
  extern __shared__ int tab[];  // [3 * K * S] candidate tables
  const int e = blockIdx.x;
  obs_tail::load_tables(geom, K, S, tab);
  __syncthreads();
  obs_tail::agents(obs_tail::V2Words(wide), imgp + (size_t)e * HP * WPC, tab, HP, WPC, K * S, row0,
                   lane0, gplus, out, attempted, e, A, G, out_w);
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
extern "C" int obs_tail_dyn_v2_launch(
    const void* imgp, const void* row0, const void* lane0, const void* gplus, const void* geom,
    void* out, void* attempted, int HP, int WPC, int E, int A, int S, int G, int K, int out_w,
    int wide, void* stream) {
  const int smem = 3 * K * S * (int)sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        obs_tail_dyn_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  obs_tail_dyn_v2_kernel<<<E, obs_tail::block_threads(A), smem, (cudaStream_t)stream>>>(
      (const int*)imgp, (const int*)row0, (const int*)lane0, (const int*)gplus, (const int*)geom,
      (int*)out, (int*)attempted, HP, WPC, A, S, G, K, out_w, wide);
  return (int)cudaGetLastError();
}
