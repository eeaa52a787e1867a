// Stable row compaction of the non-fused observation path, written for
// Hopper (sm_90a).
//
// Replaces: compact_rows_pallas, mettagrid_tpu/engine/pallas_kernels.py:110
// (kernel B8, with _compact_block :71 and _prefix_sum_lanes :58).
//
// What it computes, per row r of words int32 [R, C]: the non-negative words
// of the row, in order, in out[r, :T], -1 in the rest of the row; words at
// ranks T and beyond are dropped.
//
// What bounds it: bytes. At the territory bench shapes (98,304 rows of
// C = 971 candidate words, T = 500) it reads 382 MB and writes 197 MB; each
// word costs a compare, a ballot and a popcount.
//
// What the design does about it: the TPU kernel front-packed a row block in
// VMEM by log2(C) rolled passes over an exclusive prefix sum (an int8 matmul
// or Hillis-Steele shifts), because Mosaic has no lane scatter. Here one warp
// takes one row and ranks its words 32 at a time with __ballot_sync and
// __popc (obs_tail::warp_rank, the ranking the observation tails run), so
// every word is read once, coalesced, and every output word written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "obs_tail.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void compact_rows_kernel(const int* __restrict__ words, int* __restrict__ out, int R, int C, int T) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int* w = words + (size_t)row * C;
  int* o = out + (size_t)row * T;
  int count = 0;
  for (int j0 = 0; j0 < C; j0 += 32) {
    const int j = j0 + lane;
    const int word = j < C ? w[j] : -1;
    const int rank = obs_tail::warp_rank(word >= 0, count);
    if (word >= 0 && rank < T) o[rank] = word;
  }
  for (int i = (count < T ? count : T) + lane; i < T; i += 32) o[i] = -1;
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
extern "C" int compact_rows_launch(const void* words, void* out, int R, int C, int T, void* stream) {
  const int blocks = (R + kWarps - 1) / kWarps;
  compact_rows_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>((const int*)words, (int*)out, R, C, T);
  return (int)cudaGetLastError();
}
