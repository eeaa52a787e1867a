// The persistent-block machinery of kernels B1 (obs_tail_static_v2.cu) and
// B2 (obs_tail_dynobj_v2.cu), for Hopper (sm_90a). They compute the v2 tail
// of obs_tail.cuh, word for word; this header holds how:
//
// - a candidate plan in registers (Plan): lane l owns candidates
//   j = 32 r + l for its R rounds, each packed in one register (the byte
//   offset of the candidate from the window's corner, the window row, the
//   location byte, and flags for a global word or no candidate); built once
//   per block, so no env rebuilds candidate tables, and each round is
//   branch-free;
// - one bounds test per agent: when the whole window lies inside the staged
//   image the agent takes the unchecked loop (one shared load per
//   candidate), else the checked loop of obs_tail::FlatImage;
// - rows written by bulk store (agents_bulk): each warp front-compacts its
//   agent's row into one of two row buffers in shared memory, fences the
//   generic proxy against the async proxy, and one lane stores the row to
//   device memory with cp.async.bulk, so one agent's store overlaps the
//   compaction of the next;
// - the mbarrier and 1-D bulk copy (TMA) primitives with which B1 stages
//   each env's image, and the 4-byte cp.async (stage_runs) with which both
//   stage an env's tables ahead of its tail.

#pragma once

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "obs_tail.cuh"

namespace tail_bulk {

constexpr unsigned kDead = 1u << 31;    // no candidate (j >= G + K*S)
constexpr unsigned kGlobal = 1u << 30;  // a global word (j < G)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory loads and stores at 32-bit shared addresses. The load is
// free to move among the other instructions (it reads an image that no
// thread writes between the block's barriers); the stores keep their order.
__device__ __forceinline__ int lds(uint32_t addr) {
  int v;
  asm("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts(uint32_t addr, int v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts4(uint32_t addr, int v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};" ::"r"(addr), "r"(v) : "memory");
}

// t / d for t < 2^32 / d, given m = divisor_magic(d): one multiply-high in
// place of an integer division (exact: t * (m * d - 2^32) < 2^32).
__host__ __device__ __forceinline__ unsigned divisor_magic(unsigned d) { return d == 1 ? 0u : 0xFFFFFFFFu / d + 1u; }

__device__ __forceinline__ int div_by(int t, int d, unsigned m) { return d == 1 ? t : (int)__umulhi((unsigned)t, m); }

// ---- mbarriers and the 1-D bulk copy (TMA) into shared memory ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Orders the calling thread's generic-proxy accesses to shared memory
// before its later async-proxy ones (bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One thread: copies `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device memory to shared memory; `bar` completes its phase
// when they have landed. The source is marked to stay in L2 (evict_last):
// the tails read the same few pooled maps for every env.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  uint64_t keep;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(keep)
      : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- bulk stores from shared memory ----

// One thread: stores `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from shared memory to device memory as one bulk group, marked to
// leave L2 first (evict_first): the rows stream out and this kernel never
// reads them back.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  uint64_t stream;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(stream));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes), "l"(stream)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until at most one bulk store of the calling thread still reads its source.
__device__ __forceinline__ void bulk_wait_read_one() { asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory"); }

// Until every bulk store of the calling thread has completed.
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;" ::: "memory"); }

// ---- 4-byte asynchronous copies into shared memory ----

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// Until at most the N newest committed groups of the calling thread are
// pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Host: raises the dynamic shared memory that kernel `k` may use to `smem`
// bytes where `*allowed`, the kernel's own record of what it was allowed
// (kept in its source's anonymous namespace, so that no two libraries
// share it), is below that; launches then skip the call.
inline cudaError_t allow_smem(const void* k, int smem, int* allowed) {
  if (smem <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) *allowed = smem;
  return err;
}

// ---- the candidate plan ----

// Candidate j = 32 r + lane of the calling lane, for r < R: G globals, then
// the K window cells of `geom` (rows (u, v, loc)) times S slots. An entry is
// off4 | u << 18 | loc << 22, off4 = 4 * (u * WPC + v * S + s) the byte
// offset of the candidate from its window's corner (below 2^18: the staged
// image is smaller), or kGlobal | loc << 22 for a global word, or kDead
// past the last candidate; either of the last two has off4 = 0, which reads
// the corner harmlessly. Call with every lane of a warp.
template <int R>
struct Plan {
  unsigned en[R];
  int win_rows;   // 1 + the largest window row u
  int win_lanes;  // 1 + the largest window lane v * S + s

  __device__ void build(const int* __restrict__ geom, int G, int K, int S, int WPC) {
    const int lane = threadIdx.x & 31;
    const int C = G + K * S;
    int max_u = 0, max_l = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = 32 * r + lane;
      unsigned e = kDead;
      if (j < G) {
        e = kGlobal | (obs_tail::kGlobalLocation << 22);
      } else if (j < C) {
        const int jj = j - G;
        const int k = jj / S;
        const int u = geom[3 * k];
        const int dl = geom[3 * k + 1] * S + (jj - k * S);
        const int loc = geom[3 * k + 2];
        const int off = u * WPC + dl;
        if (u < 0 || u > 15 || dl < 0 || off >= (1 << 16) || loc < 0 || loc > 0xFF) {
          printf("obs tail plan: window cell %d (u %d, lane %d, loc %d) does not pack\n", k, u, dl, loc);
          assert(false);
        }
        e = 4u * (unsigned)off | ((unsigned)u << 18) | ((unsigned)loc << 22);
        max_u = max(max_u, u);
        max_l = max(max_l, dl);
      }
      en[r] = e;
    }
    win_rows = (int)__reduce_max_sync(0xFFFFFFFFu, (unsigned)max_u) + 1;
    win_lanes = (int)__reduce_max_sync(0xFFFFFFFFu, (unsigned)max_l) + 1;
  }
};

// The v2 word of a valid cell with location byte `loc`: obs_tail::V2Words
// rewritten for fewer instructions, word for word the same. With
// c = cell - 1 and sh = 15 (14 when wide), the packing c | loc << sh has
// location field lf = ((c >> sh) & 0xFF) | loc, feature bits c & feat_mask
// (the location lies above them) and value byte c & 0xFF; the word is
// lf | (c & feat_mask) | (c & 0xFF) << 16, one byte permute (bytes lf, c's
// byte 1, c's byte 0, 0) and a mask; a location field of 0xFF is the empty
// word.
struct V2Pack {
  static constexpr int kEmpty = obs_tail::V2Words::kEmpty;
  int sh;
  unsigned keep;  // 0xFF00FF | feat_mask
  __device__ explicit V2Pack(int wide) : sh(wide ? 14 : 15), keep(wide ? 0xFF3FFFu : 0xFF7FFFu) {}
  __device__ __forceinline__ int operator()(int cell, unsigned loc) const {
    const unsigned c = (unsigned)(cell - 1);
    const unsigned lf = ((c >> sh) & 0xFFu) | loc;
    const unsigned w = __byte_perm(lf, c, 0x1450) & keep;
    return lf == 0xFFu ? kEmpty : (int)w;
  }
};

// The tail of every agent of one env over the staged image `img` int32
// [HP, WPC]: the env's window corners `row0`, `lane0` [A] and globals
// `gplus` [A, G] (staged in shared memory by the caller, or in device
// memory), its output rows `out` [A, out_w] and counts `attempted` [A].
// Each row is compacted into `rows`, this warp's two row buffers
// [2][out_w], and stored from there by bulk copy; `nrow` counts the rows
// this warp stored so far (which buffer is next). Requires G <= 32 (every
// global in round 0) and out_w % 4 == 0. Call after a __syncthreads that
// follows the last write to the image and the tables; drain with
// bulk_wait_all (lane 0) before the block exits.
template <int R>
__device__ inline void agents_bulk(const V2Pack fmt, const Plan<R>& plan, const int* img, int HP, int WPC,
                                   const int* row0, const int* lane0, const int* gplus, int* __restrict__ out,
                                   int* __restrict__ attempted, int A, int G, int out_w, int* rows,
                                   unsigned& nrow) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int a = warp; a < A; a += nwarps) {
    const int r0 = row0[a];
    const int l0 = lane0[a];
    const int gword = lane < G ? gplus[a * G + lane] : 0;
    int* row = rows + (nrow & 1) * out_w;
    const uint32_t row_s = smem_addr(row);
    // The store issued from this buffer two rows ago has read it.
    if (lane == 0) bulk_wait_read_one();
    __syncwarp();
    int count = 0;
    // One round: rank the valid lanes by ballot, store each valid word at
    // its rank in the row buffer (ranks at or past out_w dropped).
    auto emit = [&](int cell, unsigned en) {
      const bool ok = cell > 0;
      const unsigned vote = __ballot_sync(0xFFFFFFFFu, ok);
      const int rank = count + __popc(vote & below);
      count += __popc(vote);
      const int w = fmt(cell, (en >> 22) & 0xFFu);
      if (ok && rank < out_w) sts(row_s + 4u * (unsigned)rank, w);
    };
    if (r0 >= 0 && r0 + plan.win_rows <= HP && l0 >= 0 && l0 + plan.win_lanes <= WPC) {
      // The whole window lies inside the image: one load per candidate.
      const uint32_t corner = smem_addr(img) + 4u * (unsigned)(r0 * WPC + l0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const unsigned en = plan.en[r];
        int cell = lds(corner + (en & 0x3FFFFu));
        if (en & kDead) cell = 0;
        if (r == 0 && (en & kGlobal)) cell = gword;
        emit(cell, en);
      }
    } else {
      const obs_tail::FlatImage fetch{img, HP, WPC};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const unsigned en = plan.en[r];
        const int u = (en >> 18) & 15;
        int cell = fetch(r0, u, l0 + (int)((en & 0x3FFFFu) >> 2) - u * WPC);
        if (en & kDead) cell = 0;
        if (r == 0 && (en & kGlobal)) cell = gword;
        emit(cell, en);
      }
    }
    // Empty words after the valid ones: single words up to a 16-byte
    // boundary, then 16-byte stores.
    const int n = count < out_w ? count : out_w;
    const int n4 = (n + 3) & ~3;
    if (n + lane < n4) sts(row_s + 4u * (unsigned)(n + lane), V2Pack::kEmpty);
    for (int i = n4 + 4 * lane; i < out_w; i += 128) sts4(row_s + 4u * (unsigned)i, V2Pack::kEmpty);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      bulk_store(out + (size_t)a * out_w, row, (unsigned)out_w * 4u);
      attempted[a] = count;
    }
    ++nrow;
  }
}

// A run of n words at src in device memory.
struct Run {
  const int* src;
  int n;
};

// Every thread of the block: its share of the runs, copied back to back
// into `dst` (shared memory) with 4-byte cp.async; the caller commits the
// group.
template <int kParts>
__device__ inline void stage_runs(int* dst, const Run (&runs)[kParts]) {
  int at = 0;
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    for (int t = threadIdx.x; t < runs[p].n; t += blockDim.x) cp_async4(dst + at + t, runs[p].src + t);
    at += runs[p].n;
  }
}

}  // namespace tail_bulk
