// Window slices of the non-fused observation path, written for Hopper
// (sm_90a).
//
// Replaces: window_slices_pallas, mettagrid_tpu/engine/pallas_kernels.py:154
// (kernel B7).
//
// What it computes, per env e, agent a, window cell k (Manhattan order, table
// `geom`) and channel c < Ch:
//   out[e, a, k, c] = img[e, row0[e, a] + u_k, lane0[e, a] + v_k*Ch + c],
// 0 where that lies outside the image. img is the padded interleaved cell
// image int32 [E, HP, WPC] (Ch channels per cell: S token words, the token
// count and, with the AOE mask, the winning tag + 1). The TPU kernel rolled
// each env's image twice per agent and wrote [RP, LP] tiles whose window sat
// in [:OH, :OW*Ch]; the caller then took the Manhattan order with a gather.
// Here the kernel writes that order directly, and nothing else.
//
// What bounds it: bytes. At the territory bench shapes (4096 envs x 24
// agents, 40 x 384 image words, K = 121, Ch = 9) it reads the 252 MB image
// and writes 428 MB of windows; each output word costs a few integer
// operations.
//
// What the design does about it: one block per env copies the env's image
// into shared memory with 16-byte loads (61 KB there) and then writes the
// A * K * Ch output words of the env in order, neighbouring threads on
// neighbouring addresses, each read from shared memory through an offset
// table. An image too large for shared memory is read in place from device
// memory (through L2), with the same code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void window_slices_kernel(
    const int* __restrict__ img,    // [E, HP, WPC]
    const int* __restrict__ row0,   // [E, A]
    const int* __restrict__ lane0,  // [E, A]
    const int* __restrict__ geom,   // [K, 3]: (u, v, loc) per window cell
    int* __restrict__ out,          // [E, A, K, Ch]
    int HP, int WPC, int A, int K, int Ch, int staged) {
  extern __shared__ int smem[];  // [HP * WPC] image if staged, then [2 * K * Ch] tables
  const int KC = K * Ch;
  const int e = blockIdx.x;
  const int image_words = staged ? HP * WPC : 0;
  int* tab_u = smem + image_words;
  int* tab_l = tab_u + KC;
  const int* src = img + (size_t)e * HP * WPC;
  if (staged) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    int4* dst4 = reinterpret_cast<int4*>(smem);
    for (int i = threadIdx.x; i < image_words / 4; i += blockDim.x) dst4[i] = src4[i];
  }
  for (int j = threadIdx.x; j < KC; j += blockDim.x) {
    const int k = j / Ch;
    tab_u[j] = geom[3 * k];
    tab_l[j] = geom[3 * k + 1] * Ch + (j - k * Ch);
  }
  __syncthreads();
  const int* im = staged ? smem : src;
  for (int a = 0; a < A; ++a) {
    const int r0 = row0[(size_t)e * A + a];
    const int l0 = lane0[(size_t)e * A + a];
    int* o = out + ((size_t)e * A + a) * KC;
    for (int j = threadIdx.x; j < KC; j += blockDim.x) {
      const int r = r0 + tab_u[j];
      const int l = l0 + tab_l[j];
      o[j] = (r >= 0 && r < HP && l >= 0 && l < WPC) ? im[r * WPC + l] : 0;
    }
  }
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
extern "C" int window_slices_launch(
    const void* img, const void* row0, const void* lane0, const void* geom, void* out,
    int E, int HP, int WPC, int A, int K, int Ch, int staged, void* stream) {
  // The image (when staged), then two tables (kernels/window_slices.py: smem_bytes).
  const int smem = ((staged ? HP * WPC : 0) + 2 * K * Ch) * (int)sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(window_slices_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  window_slices_kernel<<<E, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)img, (const int*)row0, (const int*)lane0, (const int*)geom, (int*)out, HP, WPC, A, K, Ch,
      staged);
  return (int)cudaGetLastError();
}
