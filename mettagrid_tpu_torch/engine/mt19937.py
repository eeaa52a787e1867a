"""A per-env std::mt19937 with libstdc++'s draw semantics, in int64 tensors.

Counterpart of the reference's engine/mt19937.py (the twin of the C++
engine's generator, mettagrid_c.cpp:51-52). The reference engine owns one
std::mt19937 per env and draws from it for the agent-order shuffle
(mettagrid_c.cpp:957-960), the events' max_targets shuffles
(handler/event.cpp:41-44) and order_by=random query caps
(core/query_system.cpp:78-79). Those draws depend on the data (how many
targets pass at a step), so the stream lives in the step's state.

State: int64[E, 625], the 624 twister words and the cursor, every word in
[0, 2^32). All arithmetic is 32-bit arithmetic carried in int64: every
shift left and every product is masked back to 32 bits, and the 32 x 32
bit product of uniform_int is taken in 16-bit limbs (its full 64 bits would
overflow int64). Draws are masked per env, so only the envs that would draw
in the reference advance.

* mt_init, _twist and _temper are std::mt19937's seeding, generation and
  tempering;
* uniform_int is std::uniform_int_distribution's Lemire downscale with
  rejection for a 32-bit engine (libstdc++ bits/uniform_int_dist.h
  _S_nd<uint64, uint32>); the rejection loop repeats until no env needs
  another draw, one host read per round;
* shuffle_perm is libstdc++'s std::shuffle for n < 65536
  (bits/stl_algo.h): pairs of swap positions from one draw over
  [0, (i+1)(i+2)), after one range-2 draw when n is even.

Speed is no aim: only the reference-RNG step (make_step(reference_rng=True))
draws from it.
"""

from __future__ import annotations

import torch

from mettagrid_tpu_torch.profiling import trace

MT_N = 624
MT_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF
_I64 = torch.int64


def mt_init(seeds: torch.Tensor) -> torch.Tensor:
    """Seed per-env twisters. seeds: integer[E] (taken mod 2^32) -> state
    int64[E, 625]."""
    prev = seeds.to(_I64) & _MASK32
    words = [prev]
    for i in range(1, MT_N):
        # 1812433253 < 2^31 and prev < 2^32: the product fits int64.
        prev = (1812433253 * (prev ^ (prev >> 30)) + i) & _MASK32
        words.append(prev)
    cursor = torch.full_like(prev, MT_N)
    return torch.stack(words + [cursor], dim=1)


def _twist(mt: torch.Tensor) -> torch.Tensor:
    """One generation of all 624 words, staged as the in-place C++ loop
    reads them: word (i + M) % N is already new for i >= N - M, and the last
    word's y term reads the new word 0."""
    y = (mt & _UPPER) | (torch.roll(mt, -1, dims=1) & _LOWER)
    xa = (y >> 1) ^ torch.where((y & 1) == 1, _MATRIX_A, 0)
    NM = MT_N - MT_M  # 227
    n1 = mt[:, MT_M : MT_M + NM] ^ xa[:, :NM]  # i in [0, 227)
    n2 = n1 ^ xa[:, NM : 2 * NM]  # i in [227, 454)
    n3 = n2[:, : MT_N - 1 - 2 * NM] ^ xa[:, 2 * NM : MT_N - 1]  # i in [454, 623)
    y_last = (mt[:, MT_N - 1] & _UPPER) | (n1[:, 0] & _LOWER)
    xl = (y_last >> 1) ^ torch.where((y_last & 1) == 1, _MATRIX_A, 0)
    n_last = n2[:, (MT_N - 1 + MT_M) % MT_N - NM] ^ xl  # new[396] = n2[169]
    return torch.cat([n1, n2, n3, n_last[:, None]], dim=1)


def _temper(y: torch.Tensor) -> torch.Tensor:
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & 0x9D2C5680)
    y = y ^ ((y << 15) & 0xEFC60000)
    return y ^ (y >> 18)


def mt_next(state: torch.Tensor, active: torch.Tensor):
    """One tempered 32-bit draw per env where active; the other envs neither
    advance their cursor nor twist. Returns (state, int64[E])."""
    mt, idx = state[:, :MT_N], state[:, MT_N]
    need_twist = active & (idx >= MT_N)
    if trace.host_read(need_twist.any(), "mt.twist"):
        mt = torch.where(need_twist[:, None], _twist(mt), mt)
        idx = torch.where(need_twist, 0, idx)
    pos = idx.clamp(max=MT_N - 1)
    y = mt.gather(1, pos[:, None])[:, 0]
    idx = torch.where(active, idx + 1, idx)
    return torch.cat([mt, idx[:, None]], dim=1), _temper(y)


def _mul32(u: torch.Tensor, r: torch.Tensor):
    """(low 32 bits, high 32 bits) of u * r for u, r in [0, 2^32), in 16-bit
    limbs."""
    ul, uh = u & 0xFFFF, u >> 16
    rl, rh = r & 0xFFFF, r >> 16
    t = ul * rl
    t1 = uh * rl + (t >> 16)
    t2 = ul * rh + (t1 & 0xFFFF)
    hi = uh * rh + (t1 >> 16) + (t2 >> 16)
    lo = ((t2 & 0xFFFF) << 16) | (t & 0xFFFF)
    return lo, hi


def uniform_int(state: torch.Tensor, range_: torch.Tensor, active: torch.Tensor):
    """std::uniform_int_distribution<uint64>(0, range - 1) over the 32-bit
    engine: the Lemire downscale with rejection. range_: integer[E] in
    [1, 2^32] (an env with range 1 still draws once, as the reference
    does). Returns (state, int64[E] in [0, range), 0 where not active)."""
    if not trace.host_read(active.any(), "mt.uniform_active"):
        return state, torch.zeros_like(range_, dtype=_I64)
    r = range_.to(_I64)
    threshold = ((1 << 32) - r) % r
    state, u = mt_next(state, active)
    lo, hi = _mul32(u, r)
    need = active & (lo < threshold)
    while trace.host_read(need.any(), "mt.uniform_reject"):
        state, u = mt_next(state, need)
        lo2, hi2 = _mul32(u, r)
        lo = torch.where(need, lo2, lo)
        hi = torch.where(need, hi2, hi)
        need = need & (lo < threshold)
    return state, torch.where(active, hi, 0)


def _swap(perm: torch.Tensor, a: torch.Tensor, b: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """perm[e, a[e]] <-> perm[e, b[e]] where active[e] (an inactive env's
    positions may lie outside perm)."""
    top = perm.shape[1] - 1
    va = perm.gather(1, a[:, None].long().clamp(0, top))
    vb = perm.gather(1, b[:, None].long().clamp(0, top))
    pos = torch.arange(perm.shape[1], device=perm.device)[None, :]
    act = active[:, None]
    out = torch.where(act & (pos == a[:, None]), vb, perm)
    return torch.where(act & (pos == b[:, None]), va, out)


def shuffle_perm(state: torch.Tensor, n: torch.Tensor, max_n: int, active: torch.Tensor):
    """libstdc++'s std::shuffle of identity[0..n) per env (n: int[E] <=
    max_n, < 65536). Envs not active or with n < 2 draw nothing and keep the
    identity. Returns (state, perm int32[E, max_n]): perm[e, j] is the
    original index at shuffled position j (positions >= n[e] hold their
    own)."""
    E = n.shape[0]
    n = n.to(torch.int32)
    perm = torch.arange(max_n, dtype=torch.int32, device=n.device)[None, :].expand(E, max_n).contiguous()
    live = active & (n >= 2)
    if max_n < 2 or not trace.host_read(live.any(), "mt.shuffle_live"):
        return state, perm
    # An even n first draws uniform(0, 1) and swaps positions 1 and j
    # (stl_algo.h __shuffle's leading swap when (last - first) % 2 == 0).
    even = live & (n % 2 == 0)
    state, j0 = uniform_int(state, torch.full((E,), 2, dtype=_I64, device=n.device), even)
    perm = _swap(perm, torch.ones((E,), dtype=torch.int32, device=n.device), j0.to(torch.int32), even)
    # Pair p touches i = 2p (even n) or 2p - 1 (odd n); one draw over
    # [0, (i+1)(i+2)) gives the two positions (x // (i+2), x % (i+2)). Pairs
    # past every live env's n draw nothing, so the loop stops at the largest.
    top = trace.host_read(torch.where(live, n, 0).max(), "mt.shuffle_top", int)
    for p in range(1, min((max_n - 1) // 2, (top - 1) // 2) + 1):
        i = torch.where(n % 2 == 0, 2 * p, 2 * p - 1).to(_I64)
        part = live & (i <= n - 2)
        b1 = i + 2
        state, x = uniform_int(state, ((i + 1) * b1).clamp(min=1), part)
        perm = _swap(perm, i.to(torch.int32), (x // b1).to(torch.int32), part)
        perm = _swap(perm, (i + 1).to(torch.int32), (x % b1).to(torch.int32), part)
    return state, perm
