// The persistent-block machinery of the observation tails B1
// (obs_tail_static_v2.cu), B2 (obs_tail_dynobj_v2.cu), B3
// (obs_tail_dyn_v2.cu), B4 (obs_tail_static_v1.cu), B5 (obs_tail_v1.cu), B6a
// (obs_tail_static_v3.cu) and B6b (obs_tail_dyn_v3.cu), for Hopper (sm_90a).
// They compute the tails of obs_tail.cuh, word for word (B4 and B5 the v1
// words, the others the v2 words). This header holds how:
//
// - a candidate plan in registers (Plan): lane l owns candidates
//   j = 32 r + l for its R rounds, each packed in one register (the offset
//   of the candidate from the window's corner, the window row, the location
//   byte, and flags for a global word or no candidate); built once per
//   block, so no env rebuilds candidate tables, and each round is
//   branch-free. Past 32 rounds (windows of many token slots) an instance
//   built with kMore keeps 12 rounds in registers and the entries of the
//   further rounds in shared memory, in the same format, at the end of the
//   block's dynamic shared memory: one shared load per candidate. (The
//   compiler hoists each register entry's fields out of the agent loop:
//   register plans of 48 or 64 rounds spilled even at 255 registers, and 32
//   register rounds beside the shared ones at 64 and at 128; 12 do not.)
//   The offset follows the image's form (Form): a flat image,
//   or row-paired halves, where window row u lies in half u & 1 at half row
//   u >> 1 (in shared memory the half's distance is part of the offset);
// - the globals: at most 32 lie in the first round, each lane's taken from
//   a register; an instance built with kGlobalRounds (B4, whose globals may
//   number more, as value observations make them) gives more than 32 global
//   words rounds of their own ahead of the window's, read from the agent's
//   table, and plans the window candidates alone;
// - the window reads (SmemFlat, SmemPaired, DeviceFlat, DevicePaired): a
//   flat image or paired halves staged in shared memory, or a flat image or
//   paired halves read from device memory. One bounds test per agent: when
//   the whole window lies inside the image the agent takes the unchecked
//   loop (one load per candidate; from device memory a batch of rounds'
//   loads goes out before their ballots, so they overlap), else the checked
//   loop of obs_tail::FlatImage or obs_tail::PairedImage;
// - rows written by bulk store (tail_row): each warp front-compacts its
//   agent's row into one of two row buffers in shared memory, fences the
//   generic proxy against the async proxy, and one lane stores the row to
//   device memory with cp.async.bulk, so one agent's store overlaps the
//   compaction of the next (rows that are not whole 16-byte units are
//   copied out by the warp instead);
// - the env loops: static_envs (B1, B4) stages each env's pooled map (one
//   bulk copy, kept in L2) and its agent tables, adds the agents' words in
//   shared memory, and runs the tails there; over per-env images (B3, B5,
//   B6b), staged_envs stages each env's flat image (one bulk copy) onto an
//   mbarrier and its agent tables by cp.async, the env ahead while the
//   current one runs where two stages fit (B5); device_envs reads the image
//   from device memory (B3, B5, B6b), each warp walking its own agents with
//   their tables loaded two agents ahead and the next agent's window rows
//   prefetched into L2 (B6a, over the paired pool, keeps its own loop);
// - the mbarrier and 1-D bulk copy (TMA) primitives, and the 4-byte
//   cp.async (stage_runs) with which the kernels stage tables.

#pragma once

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "obs_tail.cuh"

namespace tail_bulk {

constexpr unsigned kDead = 1u << 31;    // no candidate (j >= G + K*S)
constexpr unsigned kGlobal = 1u << 30;  // a global word (j < G)
constexpr unsigned kOffMask = 0x3FFFFu;  // the offset field of a plan entry

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

// L2 policies for bulk copies: keep (evict_last: the pooled maps every env
// reads) or stream (evict_first: data read or written once).
__device__ __forceinline__ uint64_t policy_keep() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_stream() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// One thread: arrives on `bar` and expects `bytes` more to land on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// One thread: copies `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device memory to shared memory, completing on `bar` (whose
// phase must expect them), under L2 policy `policy`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// One thread: one bulk copy of `bytes` that alone completes `bar`'s phase.
// The source is marked to stay in L2 (evict_last): B1 reads the same few
// pooled maps for every env.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  const uint64_t keep = policy_keep();
  mbar_expect_tx(bar, bytes);
  bulk_copy(dst, src, bytes, bar, keep);
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

// One thread: asks L2 to fetch the 16-byte units that hold words [lo, hi)
// of device memory (a hint; nothing waits for it).
__device__ __forceinline__ void prefetch_l2(const int* lo, const int* hi) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(lo) & ~(uintptr_t)15;
  const uintptr_t b = (reinterpret_cast<uintptr_t>(hi) + 15) & ~(uintptr_t)15;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(a), "r"((unsigned)(b - a)) : "memory");
}

// ---- bulk stores from shared memory ----

// One thread: stores `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from shared memory to device memory as one bulk group, marked to
// leave L2 first (evict_first): the rows stream out and this kernel never
// reads them back.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  const uint64_t stream = policy_stream();
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

// How plan entries address a window from its corner: window row u, lane
// dl lies `u * WPC + dl` words on (flat), or `(u & 1) * half + (u >> 1) *
// WPC + dl` words on (paired: the right half `half` words after the left
// one, or `half` = 0 where the read picks the half by the entry's row),
// stored shifted left by `shift` (2: byte offsets, for shared memory; 0:
// word offsets, for device memory).
struct Form {
  int WPC;
  int paired;
  int half;
  int shift;
};

// The entry of candidate j of C (G globals, then the K window cells of
// `geom`, rows (u, v, loc), times S slots): off | u << 18 | loc << 22, off
// the candidate's offset in the plan's Form (below 2^18), or
// kGlobal | loc << 22 for a global word, or kDead past the last candidate;
// either of the last two has off = 0, which reads the corner harmlessly.
// Widens max_u and max_l by a window candidate's row and lane.
__device__ inline unsigned plan_entry(const int* __restrict__ geom, int j, int G, int C, int S, const Form f,
                                      int& max_u, int& max_l) {
  if (j < G) return kGlobal | (obs_tail::kGlobalLocation << 22);
  if (j >= C) return kDead;
  const int jj = j - G;
  const int k = jj / S;
  const int u = geom[3 * k];
  const int dl = geom[3 * k + 1] * S + (jj - k * S);
  const int loc = geom[3 * k + 2];
  const int off = (f.paired ? (u & 1) * f.half + (u >> 1) * f.WPC : u * f.WPC) + dl;
  if (u < 0 || u > 15 || dl < 0 || off >= (int)((kOffMask + 1) >> f.shift) || loc < 0 || loc > 0xFF) {
    printf("obs tail plan: window cell %d (u %d, lane %d, loc %d) does not pack\n", k, u, dl, loc);
    assert(false);
  }
  max_u = max(max_u, u);
  max_l = max(max_l, dl);
  return ((unsigned)off << f.shift) | ((unsigned)u << 18) | ((unsigned)loc << 22);
}

// The bytes of dynamic shared memory this launch was given.
__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned n;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n));
  return n;
}

// A shared-memory load that stays where it is written, so that the plan
// entries past the register rounds are not hoisted out of the agent loop.
__device__ __forceinline__ unsigned lds_here(uint32_t addr) {
  unsigned v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Candidate j = 32 r + lane of the calling lane, for r < R, in registers;
// with kMore, the rounds past R (ceil((G + K*S) / 32) - R of them) in
// shared memory too, [round - R][lane], in the last more_rounds * 128 bytes
// of the block's dynamic shared memory (from `smem`, its start); warp 0
// writes them, so a __syncthreads must come before they are read. Call with
// every lane of a warp.
template <int R, bool kMore = false>
struct Plan {
  static constexpr int kRounds = R;
  static constexpr bool kMoreInSmem = kMore;
  unsigned en[R];
  uint32_t more;    // kMore: the shared address of the entries past round R
  int more_rounds;  // kMore: the rounds past R
  int win_rows;     // 1 + the largest window row u
  int win_lanes;    // 1 + the largest window lane v * S + s

  __device__ void build(const int* __restrict__ geom, int G, int K, int S, const Form f,
                        const unsigned char* smem = nullptr) {
    const int lane = threadIdx.x & 31;
    const int C = G + K * S;
    int max_u = 0, max_l = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) en[r] = plan_entry(geom, 32 * r + lane, G, C, S, f, max_u, max_l);
    if constexpr (kMore) {
      more_rounds = max((C + 31) / 32 - R, 0);
      more = smem_addr(smem) + dynamic_smem_bytes() - 128u * (unsigned)more_rounds;
      for (int r = 0; r < more_rounds; ++r) {
        const unsigned e = plan_entry(geom, 32 * (R + r) + lane, G, C, S, f, max_u, max_l);
        if (threadIdx.x < 32) sts(more + 4u * (unsigned)(32 * r + lane), (int)e);
      }
    }
    win_rows = (int)__reduce_max_sync(0xFFFFFFFFu, (unsigned)max_u) + 1;
    win_lanes = (int)__reduce_max_sync(0xFFFFFFFFu, (unsigned)max_l) + 1;
  }

  // A flat image WPC words wide, staged in shared memory (B1, B2).
  __device__ void build(const int* __restrict__ geom, int G, int K, int S, int WPC,
                        const unsigned char* smem = nullptr) {
    build(geom, G, K, S, Form{WPC, 0, 0, 2}, smem);
  }
};

__device__ __forceinline__ int entry_row(unsigned en) { return (int)((en >> 18) & 15u); }

// ---- window reads ----
//
// Each read gives: kAhead (send a batch of rounds' loads before their
// ballots), form() (the plan's Form), inside(r0, l0, rows, lanes) (the
// whole window of a corner lies inside the image), corner(r0, l0) and
// load(corner, entry) (the unchecked read), and checked(r0, l0, entry) (0
// outside the image).

// A flat image int32 [HP, WPC] in shared memory.
struct SmemFlat {
  static constexpr bool kAhead = false;
  const int* img;
  int HP, WPC;
  __device__ Form form() const { return Form{WPC, 0, 0, 2}; }
  __device__ bool inside(int r0, int l0, int rows, int lanes) const {
    return r0 >= 0 && r0 + rows <= HP && l0 >= 0 && l0 + lanes <= WPC;
  }
  __device__ uint32_t corner(int r0, int l0) const { return smem_addr(img) + 4u * (unsigned)(r0 * WPC + l0); }
  __device__ int load(uint32_t c, unsigned en) const { return lds(c + (en & kOffMask)); }
  __device__ int checked(int r0, int l0, unsigned en) const {
    const int u = entry_row(en);
    return obs_tail::FlatImage{img, HP, WPC}(r0, u, l0 + (int)((en & kOffMask) >> 2) - u * WPC);
  }
};

// Window corner of a paired read: the window starting at image row r0 reads
// its rows from half row base = (r0 & 1) * HP2 + (r0 >> 1) (obs_tail.cuh's
// PairedImage).
__device__ __forceinline__ int paired_base(int r0, int HP2) { return (r0 & 1) * HP2 + (r0 >> 1); }

__device__ __forceinline__ bool paired_inside(int r0, int l0, int rows, int lanes, int HP2, int WPC) {
  const int b = paired_base(r0, HP2);
  return b >= 0 && b + ((rows - 1) >> 1) < 2 * HP2 && l0 >= 0 && l0 + lanes <= WPC;
}

// The two paired halves, int32 [2*HP2, WPC] each, back to back in shared
// memory from `left`: the plan's offsets carry the half.
struct SmemPaired {
  static constexpr bool kAhead = false;
  const int* left;
  int HP2, WPC;
  __device__ int half() const { return 2 * HP2 * WPC; }
  __device__ Form form() const { return Form{WPC, 1, half(), 2}; }
  __device__ bool inside(int r0, int l0, int rows, int lanes) const {
    return paired_inside(r0, l0, rows, lanes, HP2, WPC);
  }
  __device__ uint32_t corner(int r0, int l0) const {
    return smem_addr(left) + 4u * (unsigned)(paired_base(r0, HP2) * WPC + l0);
  }
  __device__ int load(uint32_t c, unsigned en) const { return lds(c + (en & kOffMask)); }
  __device__ int checked(int r0, int l0, unsigned en) const {
    const int u = entry_row(en);
    const int dl = (int)((en & kOffMask) >> 2) - (u & 1) * half() - (u >> 1) * WPC;
    return obs_tail::PairedImage{left, left + half(), HP2, WPC}(r0, u, l0 + dl);
  }
};

// A flat image int32 [HP, WPC] in device memory; `at(e)` is env e's of
// images laid back to back.
struct DeviceFlat {
  static constexpr bool kAhead = true;
  const int* img;
  int HP, WPC;
  __device__ DeviceFlat at(int e) const { return DeviceFlat{img + (size_t)e * HP * WPC, HP, WPC}; }
  __device__ Form form() const { return Form{WPC, 0, 0, 0}; }
  __device__ bool inside(int r0, int l0, int rows, int lanes) const {
    return r0 >= 0 && r0 + rows <= HP && l0 >= 0 && l0 + lanes <= WPC;
  }
  __device__ const int* corner(int r0, int l0) const { return img + r0 * WPC + l0; }
  __device__ int load(const int* c, unsigned en) const { return __ldg(c + (en & kOffMask)); }
  __device__ int checked(int r0, int l0, unsigned en) const {
    const int u = entry_row(en);
    const int r = r0 + u;
    const int l = l0 + (int)(en & kOffMask) - u * WPC;
    return (r >= 0 && r < HP && l >= 0 && l < WPC) ? __ldg(img + r * WPC + l) : 0;
  }
  // Lane i < rows: window row i of the corner (r0, l0) into L2.
  __device__ void prefetch(int r0, int l0, int rows, int lanes) const {
    const int i = threadIdx.x & 31;
    const int r = r0 + i;
    const int lo = max(l0, 0), hi = min(l0 + lanes, WPC);
    if (i < rows && r >= 0 && r < HP && lo < hi) prefetch_l2(img + r * WPC + lo, img + r * WPC + hi);
  }
};

// The two paired halves, int32 [2*HP2, WPC] each, in device memory; the
// read picks the half by the entry's window row. `at(e)` is env e's.
struct DevicePaired {
  static constexpr bool kAhead = true;
  const int* left;
  const int* right;
  int HP2, WPC;
  struct Corner {
    const int* l;
    const int* r;
  };
  __device__ DevicePaired at(int e) const {
    const size_t o = (size_t)e * 2 * HP2 * WPC;
    return DevicePaired{left + o, right + o, HP2, WPC};
  }
  __device__ Form form() const { return Form{WPC, 1, 0, 0}; }
  __device__ bool inside(int r0, int l0, int rows, int lanes) const {
    return paired_inside(r0, l0, rows, lanes, HP2, WPC);
  }
  __device__ Corner corner(int r0, int l0) const {
    const int o = paired_base(r0, HP2) * WPC + l0;
    return Corner{left + o, right + o};
  }
  __device__ int load(const Corner& c, unsigned en) const {
    return __ldg(((en >> 18) & 1u ? c.r : c.l) + (en & kOffMask));
  }
  __device__ int checked(int r0, int l0, unsigned en) const {
    const int u = entry_row(en);
    const int row = paired_base(r0, HP2) + (u >> 1);
    const int l = l0 + (int)(en & kOffMask) - (u >> 1) * WPC;
    const int* half = (u & 1) ? right : left;
    return (row >= 0 && row < 2 * HP2 && l >= 0 && l < WPC) ? __ldg(half + row * WPC + l) : 0;
  }
  __device__ void prefetch(int r0, int l0, int rows, int lanes) const {
    const int u = threadIdx.x & 31;
    const int row = paired_base(r0, HP2) + (u >> 1);
    const int lo = max(l0, 0), hi = min(l0 + lanes, WPC);
    const int* half = (u & 1) ? right : left;
    if (u < rows && row >= 0 && row < 2 * HP2 && lo < hi) prefetch_l2(half + row * WPC + lo, half + row * WPC + hi);
  }
};

// ---- word formats ----

// The v2 word of a valid cell with location byte `loc` (obs_tail.cuh's v2
// format), in few instructions. With c = cell - 1 and sh = 15 (14 when
// wide), the packing c | loc << sh has location field
// lf = ((c >> sh) & 0xFF) | loc, feature bits c & feat_mask (the location
// lies above them) and value byte c & 0xFF; the word is
// lf | (c & feat_mask) | (c & 0xFF) << 16, one byte permute (bytes lf, c's
// byte 1, c's byte 0, 0) and a mask; a location field of 0xFF is the empty
// word.
struct V2Pack {
  static constexpr int kEmpty = obs_tail::kV2Empty;
  static constexpr bool kAnyWidth = false;  // v2 rows are a multiple of 128 words
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

// The v1 word of a valid cell (obs_tail.cuh's v1 format), -1 for an empty
// slot. v1 rows may have any width (the reference's budget GP + 128 k).
struct V1Pack {
  static constexpr int kEmpty = -1;
  static constexpr bool kAnyWidth = true;
  __device__ __forceinline__ int operator()(int cell, unsigned loc) const { return (cell - 1) | (int)(loc << 16); }
};

// The v1 words in rows laid out at a pitch of whole 16-byte units (B4's
// wrapper rounds the pitch up): every row is bulk-stored, as v2 rows are.
struct V1WholeRows : V1Pack {
  static constexpr bool kAnyWidth = false;
  __device__ explicit V1WholeRows(int = 0) {}
};

// ---- one agent's row ----

// Words of a row buffer: out_w rounded up to whole 16-byte units.
__device__ __forceinline__ int row_stride(int out_w) { return (out_w + 3) & ~3; }

// The candidate rounds of one agent: `load(entry)` reads each window
// candidate, globals take `gword`, entries past the last candidate read 0;
// `emit(cell, entry)` ranks each round. kB rounds' loads go out before
// their ballots (1: each round loads, then ranks); then, for a plan with
// entries in shared memory, its further rounds the same way, at most 4
// rounds' loads at a time.
template <int kB, class P, class Load, class Emit>
__device__ __forceinline__ void rounds(const P& plan, int gword, Load load, Emit emit) {
  constexpr int R = P::kRounds;
  static_assert(R % kB == 0, "a batch of rounds divides the rounds");
#pragma unroll
  for (int r0 = 0; r0 < R; r0 += kB) {
    int cell[kB];
#pragma unroll
    for (int i = 0; i < kB; ++i) cell[i] = load(plan.en[r0 + i]);
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const unsigned en = plan.en[r0 + i];
      int c = cell[i];
      if (en & kDead) c = 0;
      if (r0 + i == 0 && (en & kGlobal)) c = gword;
      emit(c, en);
    }
  }
  if constexpr (P::kMoreInSmem) {
    // At most 4 rounds' loads ahead here: the register rounds' entries stay
    // live beside them.
    constexpr int kM = kB < 4 ? kB : 4;
    const unsigned lane = threadIdx.x & 31;
    for (int r0 = 0; r0 < plan.more_rounds; r0 += kM) {
      unsigned en[kM];
      int cell[kM];
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        en[i] = r0 + i < plan.more_rounds ? lds_here(plan.more + 4u * (32u * (unsigned)(r0 + i) + lane)) : kDead;
      }
#pragma unroll
      for (int i = 0; i < kM; ++i) cell[i] = load(en[i]);
#pragma unroll
      for (int i = 0; i < kM; ++i) emit(en[i] & kDead ? 0 : cell[i], en[i]);
    }
  }
}

// The tail of one agent, whose window starts at (r0, l0) of `read`'s image,
// with global word `gword` (lane < G; 0 elsewhere): its row out[i] [out_w]
// and count attempted[i]. The row is compacted into `rows`, this warp's two row
// buffers [2][row_stride(out_w)], and stored from there by bulk copy (or,
// for a format of any width, by the warp where out_w % 4 != 0: a branch
// that costs the v2 kernels registers, so they are compiled without it);
// `nrow` counts the rows this warp stored so far (which buffer is next).
// Requires G <= 32 (every global in round 0), or kGlobalRounds: then more
// than 32 globals, the agent's G words `gs`, take rounds of their own ahead
// of the window's (the plan holds the window candidates alone; gword is 0).
// Unless Pack::kAnyWidth, out_w % 4 == 0. Drain with bulk_wait_all (lane 0)
// before the block exits.
template <bool kGlobalRounds = false, class P, class Pack, class Read>
__device__ inline void tail_row(const Pack fmt, const P& plan, const Read& read, int r0, int l0, int gword,
                                int* __restrict__ out, int* __restrict__ attempted, size_t i, int out_w, int* rows,
                                unsigned& nrow, const int* gs = nullptr, int G = 0) {
  // Rounds whose loads a read from device memory sends before their
  // ballots: all of them up to 16 rounds, else 8.
  constexpr int kB = Read::kAhead ? (P::kRounds > 16 ? 8 : P::kRounds) : 1;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int stride = Pack::kAnyWidth ? row_stride(out_w) : out_w;
  int* row = rows + (nrow & 1) * stride;
  const uint32_t row_s = smem_addr(row);
  // The store made from this buffer two rows ago has read it.
  if (lane == 0) bulk_wait_read_one();
  __syncwarp();
  int count = 0;
  // One round: rank the valid lanes by ballot, store each valid word at its
  // rank in the row buffer (ranks at or past out_w dropped).
  auto emit = [&](int cell, unsigned en) {
    const bool ok = cell > 0;
    const unsigned vote = __ballot_sync(0xFFFFFFFFu, ok);
    const int rank = count + __popc(vote & below);
    count += __popc(vote);
    const int w = fmt(cell, (en >> 22) & 0xFFu);
    if (ok && rank < out_w) sts(row_s + 4u * (unsigned)rank, w);
  };
  if constexpr (kGlobalRounds) {
    if (G > 32) {
      for (int j0 = 0; j0 < G; j0 += 32) emit(j0 + lane < G ? gs[j0 + lane] : 0, obs_tail::kGlobalLocation << 22);
    }
  }
  if (read.inside(r0, l0, plan.win_rows, plan.win_lanes)) {
    // The whole window lies inside the image: one load per candidate.
    const auto c = read.corner(r0, l0);
    rounds<kB>(plan, gword, [&](unsigned en) { return read.load(c, en); }, emit);
  } else {
    rounds<kB>(plan, gword, [&](unsigned en) { return read.checked(r0, l0, en); }, emit);
  }
  // Empty words after the valid ones: single words up to a 16-byte
  // boundary, then 16-byte stores.
  const int n = count < out_w ? count : out_w;
  const int n4 = (n + 3) & ~3;
  if (n + lane < n4) sts(row_s + 4u * (unsigned)(n + lane), Pack::kEmpty);
  for (int i = n4 + 4 * lane; i < stride; i += 128) sts4(row_s + 4u * (unsigned)i, Pack::kEmpty);
  if (!Pack::kAnyWidth || (out_w & 3) == 0) {
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      bulk_store(out + i * out_w, row, (unsigned)out_w * 4u);
      attempted[i] = count;
    }
  } else {
    // The row does not start on a 16-byte boundary: the warp copies it out.
    __syncwarp();
    int* orow = out + i * out_w;
    for (int w = lane; w < out_w; w += 32) orow[w] = row[w];
    if (lane == 0) attempted[i] = count;
  }
  ++nrow;
}

// tail_row for every agent of one env, warp w taking agents w, w + warps,
// ...: the env's window corners `row0`, `lane0` [A] and globals `gplus`
// [A, G] (staged in shared memory by the caller, or in device memory), its
// output rows `out` [A, out_w] and counts `attempted` [A] (kGlobalRounds:
// as tail_row's). Call after a __syncthreads that follows the last write to
// a staged image and tables.
template <bool kGlobalRounds = false, class P, class Pack, class Read>
__device__ inline void agents_bulk(const Pack fmt, const P& plan, const Read& read, const int* row0,
                                   const int* lane0, const int* gplus, int* __restrict__ out,
                                   int* __restrict__ attempted, int A, int G, int out_w, int* rows, unsigned& nrow) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int a = warp; a < A; a += nwarps) {
    if constexpr (kGlobalRounds) {
      const int* gs = gplus + a * G;
      const int gword = G <= 32 && lane < G ? gs[lane] : 0;
      tail_row<true>(fmt, plan, read, row0[a], lane0[a], gword, out, attempted, a, out_w, rows, nrow, gs, G);
    } else {
      const int gword = lane < G ? gplus[a * G + lane] : 0;
      tail_row(fmt, plan, read, row0[a], lane0[a], gword, out, attempted, a, out_w, rows, nrow);
    }
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

// ---- the env loop over a pooled static image (B1, B4) ----

// The mbarriers ahead of a staged kernel's images (bytes).
constexpr int kBarrierBytes = 128;

// Persistent blocks over envs e = blockIdx.x, += gridDim.x, each env's image
// the pooled map static_imgp[map_idx[e]] int32 [HP, WPC] (P maps) plus every
// agent's S words added at (rext, lext + s). With kStages > 1 a block stages
// the env kStages - 1 ahead while it runs the current one: one thread copies
// its pooled map with one bulk copy onto that stage's mbarrier, marked to
// stay in L2 (every env reads one of the same few maps), and every thread
// copies the env's agent tables (window corners, agent positions and words,
// globals) with cp.async; with one stage the block stages each env just
// before its tail. The agents' words are added with shared atomics once the
// copies have landed (agents never share a cell; the atomics keep the sum
// the reference computes even if they did). kGlobalRounds: globals past the
// first round (tail_row), and the plan holds the window candidates alone
// where there are more than 32. Shared memory: an mbarrier per stage (128
// bytes reserved), the image buffers [kStages][HP * WPC], the agent tables
// [kStages][A * (4 + S + G)] (row0, lane0, rext, lext, words, gplus; padded
// to 16 bytes), then each warp's two row buffers (and, with kMore, the
// plan's entries past its register rounds, at the end). The words are
// packed by Pack(wide), a format of whole rows (out_w % 4 == 0). A map_idx
// outside [0, P) fails a device assert, like PyTorch's own index kernels,
// instead of reading another map.
template <int R, int kStages, bool kMore, bool kGlobalRounds, class Pack>
__device__ inline void static_envs(int wide, const int* __restrict__ static_imgp,
                                   const int* __restrict__ map_idx, const int* __restrict__ row0,
                                   const int* __restrict__ lane0, const int* __restrict__ rext,
                                   const int* __restrict__ lext, const int* __restrict__ words,
                                   const int* __restrict__ gplus, const int* __restrict__ geom,
                                   int* __restrict__ out, int* __restrict__ attempted, int P, int E, int HP, int WPC,
                                   int A, int S, int G, int K, int out_w, unsigned char* smem) {
  static_assert(!Pack::kAnyWidth, "static_envs bulk-stores whole rows");
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int n_img = HP * WPC;
  const unsigned img_bytes = (unsigned)n_img * 4u;
  const int n_tab = ((A * (4 + S + G)) + 3) & ~3;
  const unsigned mS = divisor_magic(S);
  int* imgs = reinterpret_cast<int*>(smem + kBarrierBytes);
  int* tabs = imgs + kStages * n_img;
  const int tid = threadIdx.x;
  int* rows = tabs + kStages * n_tab + (tid >> 5) * 2 * out_w;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  Plan<R, kMore> plan;
  plan.build(geom, kGlobalRounds && G > 32 ? 0 : G, K, S, WPC, smem);

  // Every thread: env `env`'s agent tables into stage s with cp.async (one
  // group); thread 0: its pooled map with a bulk copy onto bar[s].
  auto stage = [&](int env, int s) {
    const size_t ea0 = (size_t)env * A;
    const Run runs[6] = {{row0 + ea0, A}, {lane0 + ea0, A}, {rext + ea0, A},
                         {lext + ea0, A}, {words + ea0 * S, A * S}, {gplus + ea0 * G, A * G}};
    stage_runs(tabs + s * n_tab, runs);
    cp_async_commit();
    if (tid == 0) {
      const int m = map_idx[env];
      if (m < 0 || m >= P) {
        printf("obs tail: map_idx[%d] = %d is outside [0, %d)\n", env, m, P);
        assert(m >= 0 && m < P);
      }
      fence_proxy_async();
      bulk_load(imgs + s * n_img, static_imgp + (size_t)m * n_img, img_bytes, &bar[s]);
    }
  };
  // The first kStages - 1 envs of this block, ahead of the loop.
  for (int i = 0; i + 1 < kStages; ++i) {
    if ((int)blockIdx.x + i * (int)gridDim.x < E) stage(blockIdx.x + i * gridDim.x, i);
  }

  const Pack fmt(wide);
  unsigned nrow = 0;
  int it = 0;
  for (int e = blockIdx.x; e < E; e += gridDim.x, ++it) {
    const int s = it % kStages;
    // The stage kStages - 1 envs ahead was last read before the previous
    // env's closing __syncthreads: stage that env there now, then wait for
    // this one (with one stage, stage it now and wait).
    const int e_ahead = e + (kStages - 1) * gridDim.x;
    if (e_ahead < E) {
      stage(e_ahead, (it + kStages - 1) % kStages);
      cp_async_wait<kStages - 1>();
    } else {
      cp_async_wait_all();
    }
    int* img = imgs + s * n_img;
    const int* tab = tabs + s * n_tab;
    mbar_wait(&bar[s], (it / kStages) & 1);
    __syncthreads();

    // ---- add the agents' words ----
    const int* t_rext = tab + 2 * A;
    const int* t_lext = tab + 3 * A;
    const int* t_words = tab + 4 * A;
    for (int t = tid; t < A * S; t += blockDim.x) {
      const int a = div_by(t, S, mS);
      const int r = t_rext[a];
      const int l = t_lext[a] + (t - a * S);
      if (r >= 0 && r < HP && l >= 0 && l < WPC) atomicAdd(&img[r * WPC + l], t_words[t]);
    }
    __syncthreads();
    const size_t ea0 = (size_t)e * A;
    agents_bulk<kGlobalRounds>(fmt, plan, SmemFlat{img, HP, WPC}, tab, tab + A, t_words + A * S, out + ea0 * out_w,
                               attempted + ea0, A, G, out_w, rows, nrow);
    __syncthreads();
  }
  if ((tid & 31) == 0) bulk_wait_all();
}

// ---- env loops over per-env images (B3, B5, B6b) ----

// Shared memory of staged_envs (bytes): the mbarriers, per stage the env's
// image and its agent tables, then each warp's two row buffers (and, with
// kMore, the plan's entries past its register rounds at the end).
// tail_plan.smem_bytes computes the same on the host.

__device__ __forceinline__ int staged_tables_words(int A, int G) { return (A * (2 + G) + 3) & ~3; }

// Persistent blocks over envs e = blockIdx.x, += gridDim.x, each env's flat
// image img[e] int32 [HP, WPC] staged in shared memory: one thread copies it
// with one bulk copy onto the stage's mbarrier, streamed through L2 (each
// env's image is read once); every thread copies its share of the agent
// tables (row0, lane0, front [A, G]) with cp.async. With kStages = 2 the env
// ahead is staged while the current one runs; with one, each env is staged
// just before its tail. The image must be whole 16-byte units, 16-byte
// aligned. With kMore the plan keeps its rounds past R in shared memory.
template <int R, int kStages, bool kMore, class Pack>
__device__ inline void staged_envs(const Pack fmt, const int* __restrict__ geom, const int* __restrict__ img,
                                   int HP, int WPC, const int* __restrict__ row0, const int* __restrict__ lane0,
                                   const int* __restrict__ front, int* __restrict__ out,
                                   int* __restrict__ attempted, int E, int A, int G, int K, int S, int out_w,
                                   unsigned char* smem) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int n_img = HP * WPC;
  const int n_tab = staged_tables_words(A, G);
  int* imgs = reinterpret_cast<int*>(smem + kBarrierBytes);
  int* tabs = imgs + kStages * n_img;
  const int tid = threadIdx.x;
  int* rows = tabs + kStages * n_tab + (tid >> 5) * 2 * row_stride(out_w);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto read = [&](int s) { return SmemFlat{imgs + s * n_img, HP, WPC}; };
  Plan<R, kMore> plan;
  plan.build(geom, G, K, S, read(0).form(), smem);

  // Every thread: env `env`'s agent tables into stage s with cp.async (one
  // group); thread 0: its image with one bulk copy onto bar[s].
  auto stage = [&](int env, int s) {
    const size_t ea0 = (size_t)env * A;
    const Run runs[3] = {{row0 + ea0, A}, {lane0 + ea0, A}, {front + ea0 * G, A * G}};
    stage_runs(tabs + s * n_tab, runs);
    cp_async_commit();
    if (tid == 0) {
      fence_proxy_async();
      mbar_expect_tx(&bar[s], (unsigned)n_img * 4u);
      bulk_copy(imgs + s * n_img, img + (size_t)env * n_img, (unsigned)n_img * 4u, &bar[s], policy_stream());
    }
  };
  // The first kStages - 1 envs of this block, ahead of the loop.
  for (int i = 0; i + 1 < kStages; ++i) {
    if ((int)blockIdx.x + i * (int)gridDim.x < E) stage(blockIdx.x + i * gridDim.x, i);
  }

  unsigned nrow = 0;
  int it = 0;
  for (int e = blockIdx.x; e < E; e += gridDim.x, ++it) {
    const int s = it % kStages;
    // The stage kStages - 1 envs ahead was last read before the previous
    // env's closing __syncthreads: stage that env there now, then wait for
    // this one (with one stage, stage it now and wait).
    const int e_ahead = e + (kStages - 1) * gridDim.x;
    if (e_ahead < E) {
      stage(e_ahead, (it + kStages - 1) % kStages);
      cp_async_wait<kStages - 1>();
    } else {
      cp_async_wait_all();
    }
    mbar_wait(&bar[s], (it / kStages) & 1);
    __syncthreads();
    const int* tab = tabs + s * n_tab;
    const size_t ea0 = (size_t)e * A;
    agents_bulk(fmt, plan, read(s), tab, tab + A, tab + 2 * A, out + ea0 * out_w, attempted + ea0, A, G, out_w,
                rows, nrow);
    __syncthreads();
  }
  if ((tid & 31) == 0) bulk_wait_all();
}

// Persistent blocks over envs e = blockIdx.x, += gridDim.x, each env's image
// read from device memory through `src` (DeviceFlat or DevicePaired, at env
// 0; src.at(e) is env e's). No block-wide barrier: warp w walks its agents
// w, w + warps, ... of each of the block's envs in turn, so the warps of a
// block share the env's window rows in L1. Each warp loads the tables (row0,
// lane0, front [E, A, G]) two agents ahead and prefetches the next agent's
// window rows into L2 while the current agent's tail runs. Shared memory:
// each warp's two row buffers (and, with kMore, the plan's entries past its
// register rounds).
template <int R, bool kMore, class Pack, class Src>
__device__ inline void device_envs(const Pack fmt, const int* __restrict__ geom, const Src src,
                                   const int* __restrict__ row0, const int* __restrict__ lane0,
                                   const int* __restrict__ front, int* __restrict__ out,
                                   int* __restrict__ attempted, int E, int A, int G, int K, int S, int out_w,
                                   unsigned char* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int* rows = reinterpret_cast<int*>(smem) + warp * 2 * row_stride(out_w);
  Plan<R, kMore> plan;
  plan.build(geom, G, K, S, src.form(), smem);
  if constexpr (kMore) __syncthreads();  // the plan's entries in shared memory
  if (warp >= A) return;

  struct Item {
    int e, a, r0, l0, g;
  };
  auto item = [&](int e, int a) {
    Item it{e, a, 0, 0, 0};
    if (e < E) {
      const size_t ea = (size_t)e * A + a;
      it.r0 = __ldg(row0 + ea);
      it.l0 = __ldg(lane0 + ea);
      if (lane < G) it.g = __ldg(front + ea * G + lane);
    }
    return it;
  };
  auto next = [&](const Item& it) {
    return it.a + nwarps < A ? item(it.e, it.a + nwarps) : item(it.e + (int)gridDim.x, warp);
  };
  Item cur = item(blockIdx.x, warp);
  Item nxt = next(cur);
  unsigned nrow = 0;
  while (cur.e < E) {
    if (nxt.e < E) src.at(nxt.e).prefetch(nxt.r0, nxt.l0, plan.win_rows, plan.win_lanes);
    const Item after = next(nxt);
    tail_row(fmt, plan, src.at(cur.e), cur.r0, cur.l0, cur.g, out, attempted, (size_t)cur.e * A + cur.a, out_w, rows,
             nrow);
    cur = nxt;
    nxt = after;
  }
  if (lane == 0) bulk_wait_all();
}

}  // namespace tail_bulk
