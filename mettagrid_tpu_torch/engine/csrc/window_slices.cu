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
// What bounds it: bytes, and mostly the output. At the full_combat shapes
// (4096 envs x 24 agents, K = 121, Ch = 24, a 40 x 1024 word image) it
// writes 1.14 GB of windows and needs the image words inside some window;
// at territory's (Ch = 9, 40 x 384) 428 MB. Each output word is a copy.
//
// What the design does about it: one persistent block of 32 warps per SM
// walks the envs, and the block's threads walk the env's output in order,
// one 16-byte store (or one word, where no 16-byte store fits) at a time,
// so every warp is busy whatever the agent count. Where Ch and the image
// rows are whole 16-byte units, an entry of the window is a 16-byte unit of
// a cell, loaded at once; otherwise entries are words, and four of them
// (the last of one agent's window and the first of the next's, where they
// meet) make one store. A table in shared memory, built once per block,
// gives each entry its window row and lane offset; the agent of an output
// unit is a multiply-high away. One bounds test per entry (0 outside the
// image, word by word where a 16-byte unit straddles its edge or starts off
// a 16-byte boundary). Each thread has two to eight stores' loads in flight
// before their stores, and the stores stream (st.global.cs): the output is
// many times L2 and this kernel never reads it back. The image is read
// from device memory through L2, where one env per SM at a time (132
// images in flight) stays resident: with more blocks per SM full_combat's
// images outgrew L2 and the kernel got slower, and staging each image in
// shared memory by bulk copy, two envs at a time, gained nothing over this
// on territory's image and did not fit full_combat's (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_tail_bulk.cuh"

namespace {

template <int kWords>
struct Vec;
template <>
struct Vec<4> {
  using T = int4;
  static __device__ __forceinline__ void store(int* p, int4 v) { __stcs(reinterpret_cast<int4*>(p), v); }
};
template <>
struct Vec<1> {
  using T = int;
  static __device__ __forceinline__ void store(int* p, int v) { __stcs(p, v); }
};

// One word of a window: the image word at (r, l), 0 outside.
__device__ __forceinline__ int word_at(const int* im, int r, int l, int HP, int WPC) {
  return (r >= 0 && r < HP && l >= 0 && l < WPC) ? im[r * WPC + l] : 0;
}

// One entry of a window, at image row r and lanes [l, l + kVec): one bounds
// test for the entry, one 16-byte load where the unit lies inside the image
// on a 16-byte boundary, and word by word otherwise (0 outside).
template <int kVec>
__device__ __forceinline__ typename Vec<kVec>::T fetch(const int* im, int r, int l, int HP, int WPC) {
  if constexpr (kVec == 4) {
    if ((unsigned)r < (unsigned)HP && l >= 0 && l <= WPC - 4 && (l & 3) == 0)
      return *reinterpret_cast<const int4*>(im + r * WPC + l);
    return make_int4(word_at(im, r, l, HP, WPC), word_at(im, r, l + 1, HP, WPC), word_at(im, r, l + 2, HP, WPC),
                     word_at(im, r, l + 3, HP, WPC));
  } else {
    return word_at(im, r, l, HP, WPC);
  }
}

// Output unit g of an env (kStore words: entries g * kStore / kVec on):
// entry j of the env is entry j - a * n of agent a = j / n's window, j / n
// being the high word of j * magic (exact for j * n < 2^64). Four word
// entries in one store may run from one agent's window into the next's
// (n >= 4, so into one more at most).
template <int kVec, int kStore>
__device__ __forceinline__ typename Vec<kStore>::T unit_at(const int* im, const int2* tab, const int* r0,
                                                            const int* l0, int g, int n, unsigned long long magic,
                                                            int A, int HP, int WPC) {
  constexpr int kEntries = kStore / kVec;
  const int j = g * kEntries;
  const int a = n == 1 ? j : (int)__umul64hi((unsigned long long)j, magic);
  const int jj = j - a * n;
  if constexpr (kEntries == 1) {
    const int2 t = tab[jj];
    return fetch<kVec>(im, __ldg(r0 + a) + t.x, __ldg(l0 + a) + t.y, HP, WPC);
  } else {
    const int ra = __ldg(r0 + a), la = __ldg(l0 + a);
    const int rb = a + 1 < A ? __ldg(r0 + a + 1) : 0, lb = a + 1 < A ? __ldg(l0 + a + 1) : 0;
    int x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool next = jj + c >= n;
      const int2 t = tab[next ? jj + c - n : jj + c];
      x[c] = word_at(im, (next ? rb : ra) + t.x, (next ? lb : la) + t.y, HP, WPC);
    }
    return make_int4(x[0], x[1], x[2], x[3]);
  }
}

// kVec: words per window entry (4: 16-byte units of a cell; 1: words);
// kStore: words per store (4: 16-byte stores; 1: words).
template <int kVec, int kStore>
__global__ void __launch_bounds__(1024) window_slices_kernel(
    const int* __restrict__ img,    // [E, HP, WPC]
    const int* __restrict__ row0,   // [E, A]
    const int* __restrict__ lane0,  // [E, A]
    const int* __restrict__ geom,   // [K, 3]: (u, v, loc) per window cell
    int* __restrict__ out,          // [E, A, K, Ch]
    int E, int HP, int WPC, int A, int K, int Ch) {
  extern __shared__ int2 tab[];  // (window row u, lane offset v*Ch + c) per entry of kVec words
  using V = Vec<kStore>;
  constexpr int kUnroll = kStore == 1 ? 8 : kVec == 4 ? 4 : 2;  // stores whose loads are in flight together
  const int n = K * Ch / kVec;              // entries per window
  const int units = A * K * Ch / kStore;    // stores per env
  const unsigned long long magic = n == 1 ? 0ull : ~0ull / (unsigned)n + 1ull;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int w = j * kVec, k = w / Ch;
    tab[j] = make_int2(geom[3 * k], geom[3 * k + 1] * Ch + (w - k * Ch));
  }
  __syncthreads();

  for (int e = blockIdx.x; e < E; e += gridDim.x) {
    const int* im = img + (size_t)e * HP * WPC;
    const int* r0 = row0 + (size_t)e * A;
    const int* l0 = lane0 + (size_t)e * A;
    int* o = out + (size_t)e * units * kStore;
    for (int g0 = threadIdx.x; g0 < units; g0 += blockDim.x * kUnroll) {
      typename V::T v[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int g = g0 + i * blockDim.x;
        if (g < units) v[i] = unit_at<kVec, kStore>(im, tab, r0, l0, g, n, magic, A, HP, WPC);
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int g = g0 + i * blockDim.x;
        if (g < units) V::store(o + g * kStore, v[i]);
      }
    }
  }
}

using KernelFn = void (*)(const int*, const int*, const int*, const int*, int*, int, int, int, int, int, int);

// What each instance was allowed of dynamic shared memory (tail_bulk::allow_smem).
int allowed_smem[3] = {};

// The instance for `vec` words per entry and `store` words per store (4
// and 4, 1 and 4, or 1 and 1), with its dynamic shared memory allowed up
// to at least `smem` bytes; null for another combination.
KernelFn instance(int vec, int store, int smem, cudaError_t* err) {
  KernelFn k = nullptr;
  int i = 0;
  if (vec == 4 && store == 4) k = window_slices_kernel<4, 4>, i = 0;
  if (vec == 1 && store == 4) k = window_slices_kernel<1, 4>, i = 1;
  if (vec == 1 && store == 1) k = window_slices_kernel<1, 1>, i = 2;
  *err = k == nullptr ? cudaErrorInvalidValue : tail_bulk::allow_smem((const void*)k, smem, &allowed_smem[i]);
  return k;
}

}  // namespace

// Blocks per SM (out[0]) and registers per thread (out[1]) of the instance
// at `warps` warps per block and `smem` bytes of dynamic shared memory;
// returns the cudaError_t.
extern "C" int window_slices_occupancy(int vec, int store, int warps, int smem, int* out) {
  cudaError_t err;
  KernelFn k = instance(vec, store, smem, &err);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  out[1] = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k, 32 * warps, smem);
}

// Launches the kernel on `stream` with `grid` persistent blocks of `warps`
// warps; returns the cudaError_t of the launch.
extern "C" int window_slices_launch(
    const void* img, const void* row0, const void* lane0, const void* geom, void* out,
    int E, int HP, int WPC, int A, int K, int Ch, int vec, int store, int warps, int grid, int smem,
    void* stream) {
  cudaError_t err;
  KernelFn k = instance(vec, store, smem, &err);
  if (err != cudaSuccess) return (int)err;
  k<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int*)img, (const int*)row0, (const int*)lane0, (const int*)geom, (int*)out, E, HP, WPC, A, K, Ch);
  return (int)cudaGetLastError();
}
