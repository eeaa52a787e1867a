// The v1 observation tail over per-env images built beforehand, written for
// Hopper (sm_90a).
//
// Replaces: obs_tail_pallas, mettagrid_tpu/engine/pallas_kernels.py:211
// (kernel B5).
//
// What it computes, per env e and agent a: the v1 tail of obs_tail.cuh over
// imgp[e] (int32 [HP, WPC], +1-encoded words built beforehand): GP globals
// that may be absent (0 reads as invalid), then the window candidates in
// Manhattan order, valid when > 0, written as (cell - 1) | loc << 16 and
// front-compacted into t_pad words (-1 fill), and the attempted counts.
//
// What bounds it: bytes. At the general_lp shapes (4096 envs x 24 agents,
// HP 48, WPC 256, GP 5, K 121, S 6: 731 candidates, 24 rounds; t_pad = 512)
// the output words are 201 MB; of the 201 MB of images the function needs
// only the words inside some agent's window. The work per byte is a few
// integer operations.
//
// What the design does about it (obs_tail_bulk.cuh): persistent blocks, the
// candidate plan in registers (built once per block, branch-free rounds,
// one bounds test per agent), rows compacted in shared memory and
// bulk-stored, in one of two modes that the wrapper picks from the shapes
// (engine/kernels/tail_plan.py):
// - staged (kStages 1 or 2; the image and the warps' row buffers fit one
//   block's shared memory): each env's image, one contiguous run, arrives by
//   one bulk copy (TMA) onto an mbarrier, streamed through L2, and its agent
//   tables by cp.async; with two stages the next env is staged while the
//   current one runs. Every window read then hits shared memory;
// - device (kStages 0; the image does not fit): the window words are read
//   from device memory, eight rounds' loads sent before their ballots
//   (all of an agent's where it has at most 16 rounds), the next agent's
//   window rows prefetched into L2 and its tables loaded ahead; the warps
//   of a block share the env's rows in L1.
// Rows of any width are stored: those that are not whole 16-byte units
// (t_pad = GP + 128 k) are copied out by the warp instead of by bulk copy.
// No float arithmetic touches a word.

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_tail_bulk.cuh"

namespace {

template <int R, int kStages, bool kMore>
__global__ void __launch_bounds__(512, 2) obs_tail_v1_kernel(
    const int* __restrict__ imgp,    // [E, HP, WPC]
    const int* __restrict__ row0,    // [E, A]
    const int* __restrict__ lane0,   // [E, A]
    const int* __restrict__ gwords,  // [E, A, GP]
    const int* __restrict__ geom,    // [K, 3]: (u, v, loc) per window cell
    int* __restrict__ out,           // [E, A, t_pad]
    int* __restrict__ attempted,     // [E, A]
    int E, int HP, int WPC, int A, int S, int GP, int K, int t_pad) {
  // Shared memory, staged: the mbarriers (128 bytes), the images
  // [kStages][HP * WPC], the agent tables [kStages][A * (2 + GP)] (row0,
  // lane0, gwords; padded to 16 bytes), then each warp's two row buffers;
  // device: the row buffers alone.
  extern __shared__ __align__(128) unsigned char smem[];
  const tail_bulk::V1Pack fmt{};
  if constexpr (kStages == 0) {
    tail_bulk::device_envs<R, kMore>(fmt, geom, tail_bulk::DeviceFlat{imgp, HP, WPC}, row0, lane0, gwords, out,
                                     attempted, E, A, GP, K, S, t_pad, smem);
  } else {
    tail_bulk::staged_envs<R, kStages, kMore>(fmt, geom, imgp, HP, WPC, row0, lane0, gwords, out, attempted, E, A,
                                              GP, K, S, t_pad, smem);
  }
}

using KernelFn = void (*)(const int*, const int*, const int*, const int*, const int*, int*, int*, int, int, int,
                          int, int, int, int, int);

// The dynamic shared memory each instance is allowed, by stage count (0:
// device mode) and round count (33: the instance with plan entries in
// shared memory).
int allowed_smem[3][34] = {};

template <int kStages>
KernelFn pick_rounds(int rounds) {
  switch (rounds) {
    case 4: return obs_tail_v1_kernel<4, kStages, false>;
    case 8: return obs_tail_v1_kernel<8, kStages, false>;
    case 12: return obs_tail_v1_kernel<12, kStages, false>;
    case 16: return obs_tail_v1_kernel<16, kStages, false>;
    case 24: return obs_tail_v1_kernel<24, kStages, false>;
    case 32: return obs_tail_v1_kernel<32, kStages, false>;
    default: return rounds > 32 ? obs_tail_v1_kernel<12, kStages, true> : nullptr;
  }
}

// The instance for `rounds` candidate rounds (above 32: the one whose plan
// keeps the rounds past 12 in shared memory) and `stages` (0: device mode),
// with its dynamic shared memory allowed up to at least `smem` bytes; null
// for an unknown combination.
KernelFn instance(int rounds, int stages, int smem, cudaError_t* err) {
  KernelFn k = stages == 0 ? pick_rounds<0>(rounds)
               : stages == 1 ? pick_rounds<1>(rounds)
               : stages == 2 ? pick_rounds<2>(rounds)
                             : nullptr;
  int* allowed = &allowed_smem[stages][rounds > 32 ? 33 : rounds];
  *err = k == nullptr ? cudaErrorInvalidValue : tail_bulk::allow_smem((const void*)k, smem, allowed);
  return k;
}

}  // namespace

// Blocks per SM (out[0]) and registers per thread (out[1]) of the instance
// at `warps` warps per block and `smem` bytes of dynamic shared memory;
// returns the cudaError_t.
extern "C" int obs_tail_v1_occupancy(int rounds, int stages, int warps, int smem, int* out) {
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
extern "C" int obs_tail_v1_launch(
    const void* imgp, const void* row0, const void* lane0, const void* gwords, const void* geom,
    void* out, void* attempted, int HP, int WPC, int E, int A, int S, int GP, int K, int t_pad,
    int rounds, int stages, int warps, int grid, int smem, void* stream) {
  cudaError_t err;
  KernelFn k = instance(rounds, stages, smem, &err);
  if (err != cudaSuccess) return (int)err;
  k<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int*)imgp, (const int*)row0, (const int*)lane0, (const int*)gwords, (const int*)geom,
      (int*)out, (int*)attempted, E, HP, WPC, A, S, GP, K, t_pad);
  return (int)cudaGetLastError();
}
