// The v1 observation tail over per-env images in device memory, written for
// Hopper (sm_90a).
//
// Replaces: obs_tail_pallas, mettagrid_tpu/engine/pallas_kernels.py:211
// (kernel B5).
//
// What it computes, per env e and agent a: the v1 tail of
// obs_tail.cuh over imgp[e] (int32 [HP, WPC], +1-encoded words built
// beforehand): GP globals that may be absent, then the window candidates in
// Manhattan order, valid when > 0, written as (cell - 1) | loc << 16 and
// front-compacted into t_pad words (-1 fill), and the attempted counts.
//
// What bounds it: bytes. At the general_lp shapes (4096 envs x 24 agents,
// S = 6, t_pad = 512) the output words are 201 MB; the window cells it must
// read are at most the 201 MB image. The work per byte is a few integer
// operations.
//
// What the design does about it: the image stays in device memory (the TPU
// kernel staged image blocks in VMEM, tile-major for lane tiles, and
// permuted windows with a one-hot int8 matmul: Mosaic workarounds). Each
// warp reads its agent's window cells directly, so neighbouring lanes read
// neighbouring words of a window row, and writes every output word once.
// The candidate tables sit in shared memory. No float arithmetic touches a
// word.

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_tail.cuh"

namespace {

__global__ void obs_tail_v1_kernel(
    const int* __restrict__ imgp,    // [E, HP, WPC]
    const int* __restrict__ row0,    // [E, A]
    const int* __restrict__ lane0,   // [E, A]
    const int* __restrict__ gwords,  // [E, A, GP]
    const int* __restrict__ geom,    // [K, 3]: (u, v, loc) per window cell
    int* __restrict__ out,           // [E, A, t_pad]
    int* __restrict__ attempted,     // [E, A]
    int HP, int WPC, int A, int S, int GP, int K, int t_pad) {
  extern __shared__ int tab[];  // [3 * K * S] candidate tables
  const int e = blockIdx.x;
  obs_tail::load_tables(geom, K, S, tab);
  __syncthreads();
  obs_tail::agents(obs_tail::V1Words(), imgp + (size_t)e * HP * WPC, tab, HP, WPC, K * S, row0,
                   lane0, gwords, out, attempted, e, A, GP, t_pad);
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
extern "C" int obs_tail_v1_launch(
    const void* imgp, const void* row0, const void* lane0, const void* gwords, const void* geom,
    void* out, void* attempted, int HP, int WPC, int E, int A, int S, int GP, int K, int t_pad,
    void* stream) {
  const int smem = 3 * K * S * (int)sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(obs_tail_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  obs_tail_v1_kernel<<<E, obs_tail::block_threads(A), smem, (cudaStream_t)stream>>>(
      (const int*)imgp, (const int*)row0, (const int*)lane0, (const int*)gwords, (const int*)geom,
      (int*)out, (int*)attempted, HP, WPC, A, S, GP, K, t_pad);
  return (int)cudaGetLastError();
}
