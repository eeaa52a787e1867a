// The observation tail's definitions, for Hopper (sm_90a): the words and
// reads that the persistent tails B1-B3, B5, B6a and B6b compute with
// (obs_tail_bulk.cuh), and the one-block-per-env tail that B4
// (obs_tail_static_v1.cu) still runs.
//
// Each tail runs over an env's image, int32 [HP, WPC] of +1-encoded token
// words (0 = empty), or over its row-paired halves (PairedImage below):
//   cells = G global words (+1-encoded, 0 = absent), then
//           img[row0 + u_k][lane0 + v_k*S + s] for the K window cells in
//           Manhattan order (table `geom`) and s < S;
//   the cells > 0 are valid; they are front-compacted stably into
//   out[e, a, :out_w], ranks at or past out_w dropped, and written in one of
//   two word formats (below), the format's empty word filling the rest;
//   attempted[e, a] = the number of valid cells, globals and dropped ones
//   included.
// The v2 format (B1-B3, B6a, B6b) is loc | feat << 8 | val << 16 with
// 0xFFFFFF for empty slots: the packing (loc shifted by 15, or 14 when
// wide, over word - 1; a loc field of 0xFF reads as empty) reproduces the
// reference's packed compaction bit for bit (obs_tail_bulk.cuh V2Pack).
// The v1 format (B4, B5) is the reference's (feat << 8 | val) | loc << 16
// with -1 for empty slots.
//
// One warp per agent walks the candidates 32 at a time; __ballot_sync and
// __popc give each valid lane its output rank (warp_rank, which kernel B8,
// compact_rows.cu, also runs), so the compaction costs no extra pass and
// every output word is written exactly once, neighbouring lanes on
// neighbouring addresses.

#pragma once

#include <cuda_runtime.h>

namespace obs_tail {

constexpr int kMaxWarps = 8;
constexpr unsigned kGlobalLocation = 0xFEu;

// Shared memory of one block: the image, then three candidate tables.
inline int smem_bytes(int HP, int WPC, int K, int S) { return (HP * WPC + 3 * K * S) * (int)sizeof(int); }

// Threads per block: one warp per agent, at most kMaxWarps.
inline int block_threads(int A) { return 32 * (A < kMaxWarps ? A : kMaxWarps); }

// The candidate tables of window cell k and slot s (j = k*S + s): image row
// and lane offsets and the packed location byte, after the image in `smem`.
__device__ inline void load_tables(const int* __restrict__ geom, int K, int S, int* tab) {
  const int KS = K * S;
  for (int j = threadIdx.x; j < KS; j += blockDim.x) {
    const int k = j / S;
    const int s = j - k * S;
    tab[j] = geom[3 * k];
    tab[KS + j] = geom[3 * k + 1] * S + s;
    tab[2 * KS + j] = geom[3 * k + 2];
  }
}

// The empty v2 word.
constexpr int kV2Empty = 0xFFFFFF;

// The v1 word of a valid cell.
struct V1Words {
  static constexpr int kEmpty = -1;
  __device__ int operator()(int cell, unsigned loc) const { return (cell - 1) | (int)(loc << 16); }
};

// The output rank of the calling lane's item among the valid items of its
// warp, after `count` valid items of earlier rounds; adds this round's valid
// items to `count`. Every lane of the warp must call it.
__device__ inline int warp_rank(bool ok, int& count) {
  const unsigned vote = __ballot_sync(0xFFFFFFFFu, ok);
  const int rank = count + __popc(vote & ((1u << (threadIdx.x & 31)) - 1u));
  count += __popc(vote);
  return rank;
}

// Window reads from a flat image int32 [HP, WPC]: window row u of a window
// that starts at image row r0, lane l; 0 outside the image.
struct FlatImage {
  const int* img;
  int HP, WPC;
  __device__ int operator()(int r0, int u, int l) const {
    const int r = r0 + u;
    return (r >= 0 && r < HP && l >= 0 && l < WPC) ? img[r * WPC + l] : 0;
  }
};

// Window reads from the row-paired halves of an image (the layout of the
// reference's v3 tails, obs.py:638-658): each half is int32 [2*HP2, WPC];
// rows u < HP2 of the left half hold image rows 2u and of the right half
// 2u + 1 (the even region), rows HP2 + u hold image rows 2u + 1 and 2u + 2
// (the odd region). A window starting at image row r0 >= 0 reads its rows
// from base = (r0 & 1) * HP2 + (r0 >> 1): window row 2k from left[base + k],
// row 2k + 1 from right[base + k]. This is the reference's paired-raster to
// Manhattan table, read as addresses.
struct PairedImage {
  const int* left;
  const int* right;
  int HP2, WPC;
  __device__ int operator()(int r0, int u, int l) const {
    const int row = (r0 & 1) * HP2 + (r0 >> 1) + (u >> 1);
    const int* half = (u & 1) ? right : left;
    return (row >= 0 && row < 2 * HP2 && l >= 0 && l < WPC) ? half[row * WPC + l] : 0;
  }
};

// The v1 tail for every agent of env e over its image `img` int32 [HP,
// WPC] and the tables `tab` (load_tables), one block per env (B4). Call
// after a __syncthreads that follows the last write to either.
__device__ inline void agents(const int* img, const int* tab, int HP, int WPC, int KS,
                              const int* __restrict__ row0, const int* __restrict__ lane0,
                              const int* __restrict__ gplus, int* __restrict__ out,
                              int* __restrict__ attempted, int e, int A, int G, int out_w) {
  const V1Words fmt{};
  const FlatImage fetch{img, HP, WPC};
  const int* tab_u = tab;
  const int* tab_l = tab + KS;
  const int* tab_loc = tab + 2 * KS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int C = G + KS;
  for (int a = warp; a < A; a += nwarps) {
    const size_t ea = (size_t)e * A + a;
    const int r0 = row0[ea];
    const int l0 = lane0[ea];
    int* o = out + ea * out_w;
    int count = 0;
    for (int j0 = 0; j0 < C; j0 += 32) {
      const int j = j0 + lane;
      int cell = 0;
      unsigned loc = 0;
      if (j < G) {
        cell = gplus[ea * G + j];
        loc = kGlobalLocation;
      } else if (j < C) {
        const int jj = j - G;
        cell = fetch(r0, tab_u[jj], l0 + tab_l[jj]);
        loc = (unsigned)tab_loc[jj];
      }
      const bool ok = cell > 0;
      const int rank = warp_rank(ok, count);
      if (ok && rank < out_w) o[rank] = fmt(cell, loc);
    }
    for (int i = (count < out_w ? count : out_w) + lane; i < out_w; i += 32) o[i] = V1Words::kEmpty;
    if (lane == 0) attempted[ea] = count;
  }
}

}  // namespace obs_tail
