// The observation tail's definitions, for Hopper (sm_90a): the words and
// reads that the persistent tails B1-B5, B6a and B6b compute with
// (obs_tail_bulk.cuh holds how they run), and the warp ranking that kernel
// B8 (compact_rows.cu) runs too.
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
// with -1 for empty slots (obs_tail_bulk.cuh V1Pack).
//
// One warp per agent walks the candidates 32 at a time; __ballot_sync and
// __popc give each valid lane its output rank (warp_rank), so the
// compaction costs no extra pass and every output word is written exactly
// once.

#pragma once

#include <cuda_runtime.h>

namespace obs_tail {

// The location byte of a global token.
constexpr unsigned kGlobalLocation = 0xFEu;

// The empty v2 word.
constexpr int kV2Empty = 0xFFFFFF;

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

}  // namespace obs_tail
