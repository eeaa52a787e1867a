"""Token observations: the fused tails and the non-fused path.

Counterpart of the reference's engine/obs.py (make_obs_fn picks a route
from the program's static shapes and the caller's ``obs_tail``):

* static background (the arena and combat presets, and AOE and territories
  that write only agents): every non-agent object is provably inert
  (mutfields.static_background), so its token image is built once per
  pooled map, and each step encodes only the agents' tokens. Kernel B1
  (engine/kernels/obs_tail_static_v2.py) runs the v2 tail over the pooled
  image, kernel B4 (obs_tail_static_v1.py) the v1 tail;
* mutable background (the general preset): each step encodes every object's
  tokens, and kernel B2 (obs_tail_dynobj_v2.py) builds each env's image from
  the object tables and runs B1's tail on it;
* an env image built here, in device memory: for maps whose image is too
  large for one block's shared memory (kernel B3, obs_tail_dyn_v2.py, v2
  tail) and for mutable backgrounds off the v2 gate (kernel B5,
  obs_tail_v1.py, v1 tail, which stages each env's image in shared memory
  where it fits and reads it from device memory otherwise);
* the non-fused path, for configs no fused tail takes (the AOE mask, or
  window rows wider than 128 lanes): each env's cell image (the pooled map
  plus the agents, or every object) and, with the mask, each cell's winning
  territory tag (once per pooled map where no agent emits territory),
  interleaved into one padded image; kernel B7
  (window_slices.py) cuts every agent's window out of it in Manhattan order,
  stage 4 builds the candidate words here, and kernel B8 (compact_rows.py)
  compacts them to the token budget;
* the v3 tails, on request (``obs_tail="v3"``): B1's or B3's words read
  through a row-paired image (window rows 2k and 2k + 1 from two halves).
  Kernel B6a (obs_tail_static_v3.py) stages the paired static pool plus the
  agents, kernel B6b (obs_tail_dyn_v3.py) reads a per-env image paired
  here.

The v2 tail serves configs whose globals are always present; the v1 tail
and the non-fused path also take globals that can be absent (local
position, value observations).

Token format (reference: core/grid_object.hpp:36-47): [packed_location,
feature_id, value] uint8; empty = 0xFF, global = 0xFE. Candidate order
within a cell: the AOE mask (mettagrid_c.cpp:337-362), tags ascending,
vibe, inventory digits, protocol recipe quantities, group, agent id; cells
in Manhattan order; globals first.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from mettagrid_tpu_torch.engine import mutfields
from mettagrid_tpu_torch.engine.kernels import tail_plan
from mettagrid_tpu_torch.engine.kernels.compact_rows import compact_rows
from mettagrid_tpu_torch.engine.kernels.obs_tail_dyn_v2 import obs_tail_dyn_v2
from mettagrid_tpu_torch.engine.kernels.obs_tail_dyn_v3 import obs_tail_dyn_v3
from mettagrid_tpu_torch.engine.kernels.obs_tail_dynobj_v2 import obs_tail_dynobj_v2
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v1 import obs_tail_static_v1
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import MAX_SMEM, add_words, obs_tail_static_v2
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v3 import obs_tail_static_v3
from mettagrid_tpu_torch.engine.kernels.obs_tail_v1 import obs_tail_v1
from mettagrid_tpu_torch.engine.kernels.window_slices import window_slices
from mettagrid_tpu_torch.engine.obs_caps import compute_obs_caps, max_tokens_per_object, max_window_tokens
from mettagrid_tpu_torch.engine.program import EMPTY_TOKEN_BYTE, GLOBAL_LOCATION, EngineProgram, pack_coordinate
from mettagrid_tpu_torch.engine.state import EnvState, resolve_device
from mettagrid_tpu_torch.engine.territory import check_territories, winning_tags
from mettagrid_tpu_torch.profiling import trace

# Rows of the window the reference's fused tail stages; its padded image
# height is sized from it, and the port keeps that geometry (window OH <= 16).
_V2_RPE = 16
# Global slots whose token is emitted on every step (the fused tail's gate).
_ALWAYS_VALID_GLOBALS = ("epct", "last_action", "last_action_move", "last_reward")
OBS_TAILS = ("auto", "v3")


def _candidate_features(program: EngineProgram):
    """Feature id of every per-cell candidate token, in candidate order, and
    the number of protocol resources (0 unless some type carries one)."""
    R = program.num_resources
    P = program.num_inv_tokens
    n_tags = program.num_tags
    feat = program.feature_ids
    PR = R if ((program.type_proto_in > 0).any() or (program.type_proto_out > 0).any()) else 0
    cand_feat = np.empty(n_tags + 1 + R * P + 2 * PR + 2, dtype=np.int32)
    cand_feat[:n_tags] = feat.tag
    cand_feat[n_tags] = feat.vibe
    for r in range(R):
        for p in range(P):
            cand_feat[n_tags + 1 + r * P + p] = feat.inv[r][p]
    for r in range(PR):
        cand_feat[n_tags + 1 + R * P + r] = feat.proto_in[r]
        cand_feat[n_tags + 1 + R * P + PR + r] = feat.proto_out[r]
    cand_feat[n_tags + 1 + R * P + 2 * PR] = feat.group
    cand_feat[n_tags + 1 + R * P + 2 * PR + 1] = feat.agent_id
    return cand_feat, PR


def make_stage1(program: EngineProgram):
    """Per-object token lists over an arbitrary slot set (the reference's
    make_cell_image_fn._stage1, in integer ops).

    stage1(tid, vibe, tags, inv, alive, is_agent, group, slot_ids), each
    [B, M, ...], returns (tok int32[B, M, S], cnt int32[B, M]): the first cnt
    slots hold packed ``feat << 8 | value`` words, the rest 0. Each call
    inside a step counts its B·M slots as ``obs.stage1_slots``."""
    R = program.num_resources
    P = program.num_inv_tokens
    n_tags = program.num_tags
    base = program.token_value_base
    S = max_tokens_per_object(program, compute_obs_caps(program))
    cand_feat_np, PR = _candidate_features(program)
    divisors_np = np.array([base**p for p in range(P)], dtype=np.int32)
    tables = {}

    def consts(dev):
        if dev not in tables:
            tables[dev] = dict(
                feat=torch.from_numpy(cand_feat_np).to(dev),
                div=torch.from_numpy(divisors_np).to(dev),
                proto_in=torch.from_numpy(np.asarray(program.type_proto_in, dtype=np.int32)).to(dev),
                proto_out=torch.from_numpy(np.asarray(program.type_proto_out, dtype=np.int32)).to(dev),
            )
        return tables[dev]

    def stage1(tid, vibe, tags, inv, alive, is_agent, group, slot_ids):
        B, M = tid.shape
        trace.count("obs.stage1_slots", B * M)
        t = consts(tid.device)
        vals = [torch.arange(n_tags, dtype=torch.int32, device=tid.device).expand(B, M, n_tags), vibe[..., None]]
        oks = [tags, (vibe != 0)[..., None]]
        div = t["div"]
        digits = torch.remainder(torch.div(inv[..., None], div, rounding_mode="floor"), base)  # [B, M, R, P]
        vals.append(digits.reshape(B, M, R * P))
        oks.append((inv[..., None] >= div.clamp(min=1)).reshape(B, M, R * P))
        if PR:
            pin = t["proto_in"][tid.long()]  # [B, M, R]: quantity + 1, 0 = absent
            pout = t["proto_out"][tid.long()]
            vals += [torch.remainder((pin - 1).clamp(min=0), base), torch.remainder((pout - 1).clamp(min=0), base)]
            oks += [pin > 0, pout > 0]
        vals += [group[..., None], slot_ids[..., None]]
        oks += [is_agent[..., None], is_agent[..., None]]
        cand_val = torch.cat([v.to(torch.int32) for v in vals], dim=-1)
        cand_ok = torch.cat(oks, dim=-1) & alive[..., None]
        packed = (t["feat"] << 8) | (cand_val & 0xFF)
        pos = torch.cumsum(cand_ok, dim=-1, dtype=torch.int32) - cand_ok.to(torch.int32)  # exclusive
        dest = torch.where(cand_ok & (pos < S), pos, S)
        tok = torch.zeros((B, M, S + 1), dtype=torch.int32, device=tid.device)
        tok.scatter_(2, dest.long(), packed)
        return tok[..., :S], cand_ok.sum(dim=-1, dtype=torch.int32)

    stage1.num_slots = S
    return stage1


def _scatter_cells(tok, cnt, alive, obj_r, obj_c, H: int, W: int) -> torch.Tensor:
    """Stage 2 (the reference's make_cell_image_fn._cell_image, in integer
    ops): every object's S words and its token count summed into its cell of
    int32[B, H+1, W, S+1]; dead objects land on the padding row H."""
    B, M, S = tok.shape
    dev = tok.device
    rr = torch.where(alive, obj_r, H).long()
    cc = torch.where(alive, obj_c, 0).long()
    bb = torch.arange(B, device=dev)[:, None].expand(B, M)
    img = torch.zeros((B, H + 1, W, S + 1), dtype=torch.int32, device=dev)
    img.index_put_((bb, rr, cc), torch.cat([tok, cnt[..., None]], dim=-1), accumulate=True)
    return img


def build_static_bg(program: EngineProgram, init, device=None) -> torch.Tensor:
    """The static (non-agent) cell image of every pooled map:
    int32[P, H+1, W, S+1] (S token words, then the token count; dead objects
    land on the padding row H). Requires mutfields.static_background.

    ``device`` defaults to CUDA and raises when there is none; the obs
    function of make_obs_fn runs where this image lies."""
    device = resolve_device(device)
    stage1 = make_stage1(program)
    A = program.num_agents

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    Pm, Np = init.obj_type.shape
    slot = torch.arange(Np, dtype=torch.int32, device=device)[None, :].expand(Pm, Np)
    alive = t(init.obj_alive) & (slot >= A)
    zeros = torch.zeros((Pm, Np), dtype=torch.int32, device=device)
    tok, cnt = stage1(
        t(init.obj_type), t(init.obj_vibe), t(init.obj_tags), t(init.obj_inv), alive,
        torch.zeros((Pm, Np), dtype=torch.bool, device=device), zeros, slot,
    )
    return _scatter_cells(tok, cnt, alive, t(init.obj_r), t(init.obj_c), program.height, program.width)


def build_static_mask(program: EngineProgram, init, device=None) -> torch.Tensor:
    """The AOE mask's source on every pooled map, int32[P, H, W]: each
    cell's winning territory tag + 1 (0 where none wins), scored from the
    map's own emitters. Requires mutfields.static_mask. ``device`` as
    build_static_bg's."""
    device = resolve_device(device)
    # The fields territory_scores reads, one row per pooled map.
    pool = SimpleNamespace(**{f: torch.from_numpy(np.ascontiguousarray(getattr(init, f))).to(device)
                              for f in ("obj_type", "obj_tags", "obj_alive", "obj_r", "obj_c")})
    P = init.obj_type.shape[0]
    H, W = program.height, program.width
    cell_r = torch.arange(H, dtype=torch.int32, device=device).repeat_interleave(W).expand(P, H * W)
    cell_c = torch.arange(W, dtype=torch.int32, device=device).repeat(H).expand(P, H * W)
    return (winning_tags(program, pool, cell_r, cell_c) + 1).view(P, H, W)


def pair_rows(img: torch.Tensor, HP2: int):
    """The row-paired halves (left, right), int32[B, 2*HP2, WPC] each, of
    images img int32[B, HP, WPC] (the reference's _pair_rows_dyn and static
    pool pairing, obs.py:638-658, 749-764): rows u < HP2 pair image rows
    (2u, 2u + 1) and rows HP2 + u pair (2u + 1, 2u + 2), the left half
    holding the first of each pair; rows past the image read 0."""
    need = 2 * HP2 + 2
    if img.shape[1] < need:
        img = torch.nn.functional.pad(img, (0, 0, 0, need - img.shape[1]))
    left = torch.cat([img[:, 0 : 2 * HP2 : 2], img[:, 1 : 2 * HP2 + 1 : 2]], dim=1)
    right = torch.cat([img[:, 1 : 2 * HP2 : 2], img[:, 2 : 2 * HP2 + 2 : 2]], dim=1)
    return left.contiguous(), right.contiguous()


def tail_route(v2_ok: bool, static: bool, fits: bool, fused: bool = True, v3: bool = False,
               holds: bool = True) -> str:
    """The route of make_obs_fn's table: "nonfused" where no fused tail
    takes the config (``fused`` False: an AOE mask, or window rows wider
    than 128 lanes); with ``v3`` (the v3 tail requested and its gate
    passed) "B6a" or "B6b"; else the tail kernel "B1" to "B5", from the v2
    gate, the background kind and whether the staged kernel fits (``fits``:
    B1, B2, B4 or B6a have a launch plan, one env's image or paired halves
    in one block's shared memory). A route to a kernel that reads its image
    from device memory (B3, B5, B6b) that cannot hold the shapes (``holds``
    False: no launch plan) goes to the non-fused path, which serves every
    shape."""
    if not fused:
        return "nonfused"
    if v3:
        route = "B6a" if static and fits else "B6b"
    elif v2_ok:
        route = ("B1" if static else "B2") if fits else "B3"
    else:
        route = "B4" if static and fits else "B5"
    return route if route in ("B1", "B2", "B4", "B6a") or holds else "nonfused"


def gate_route(v2_ok: bool, static: bool, fused: bool, v3: bool, A: int, G: int, K: int, S: int, HP: int, WPC: int,
               HP2: int, out_w: int, max_smem: int = None) -> str:
    """make_obs_fn's route from the shapes alone (tail_route): the image
    int32[HP, WPC] (on the v3 routes its paired halves, 2*HP2 rows each),
    A agents, G global lanes, K window cells of S slots and out_w words per
    row. A staged kernel (B1, B2, B4, B6a) fits where it has a launch plan
    (tail_plan.holds, at least one stage and one warp's rows within
    ``max_smem``, MAX_SMEM by default); a static background that B4 does not
    fit goes to B5. B3, B5 and B6b hold where they have a launch plan within
    the card's shared memory. Never depends on the card or the plan it would
    pick."""
    max_smem = MAX_SMEM if max_smem is None else max_smem
    if v3:
        staged, device, rows = "B6a", "B6b", 2 * HP2
    elif v2_ok:
        staged, device, rows = ("B1" if static else "B2"), "B3", HP
    else:  # B5 takes a mutable background whether B4 fits or not
        staged, device, rows = "B4", "B5", HP
    fits = tail_plan.holds(staged, rows, WPC, A, G, K, S, out_w, max_smem=max_smem)
    holds = tail_plan.holds(device, rows, WPC, A, G, K, S, out_w)
    return tail_route(v2_ok, static, fits, fused, v3, holds)


def make_obs_fn(program: EngineProgram, static_bg: torch.Tensor = None, device=None, obs_tail: str = "auto",
                draws=None, static_mask: torch.Tensor = None):
    """Returns obs_fn(state, obs_buf=None) -> (observations uint8[E, A, T, 3],
    tokens_attempted int32[E, A]).

    draws: the draw source (exec.RankDraws) of order_by=random queries in
    value observations; the caller starts its step.

    static_bg: build_static_bg's pooled image where mutfields.static_background
    holds (the obs function then runs on the image's device), or None for
    the mutable background (on ``device``, which defaults to CUDA and raises
    when there is none).

    static_mask: build_static_mask's pooled AOE-mask source where
    mutfields.static_mask holds, given with static_bg; else None, and a program
    with the AOE mask scores every cell's winning tag each step.

    The tail kernel is chosen here, from the program's static shapes
    (reference obs.py:525-543, 808-842, 931-1021):

    ========== ======= ==================== ======
    background v2 gate image fits a block    kernel
    ========== ======= ==================== ======
    static     passes  yes                  B1
    static     passes  no                   B3
    static     fails   yes                  B4
    static     fails   no                   B5
    mutable    passes  yes                  B2
    mutable    passes  no                   B3
    mutable    fails   either               B5
    ========== ======= ==================== ======

    obs_tail="v3" (the reference's forced v3 tail, _FORCE_STATIC_TAIL =
    "v3") routes a program that passes the v3 gate to B6a (static
    background whose two paired halves fit a block) or B6b (otherwise, over
    the per-env image, row-paired here); a program that fails it routes as
    "auto" does. The v3 gate keeps what defines the paired layout: the v2
    gate with normal packing, 2 * OW * S <= 128, OH <= 15 and hr >= 1. It
    drops the reference's TPU limits (WPC_f <= 128 for its compiler's
    loads, and an 8 MB budget for the paired pool), as the other routes do.

    The v2 gate wants always-valid globals (no local position, no value
    observations), feature ids that fit its packing and a window of at most
    16 rows; the v1 tail (B4, B5) takes the rest whose window rows are at
    most 128 lanes wide (OW * S <= 128). An image fits a block when the
    staged kernel (B1, B2, B4, B6a) has a launch plan for it within the
    232,448 bytes of shared memory an H100 block may use (MAX_SMEM): at
    least one stage of the image (or paired halves) and agent tables and one
    warp's row buffers (engine/kernels/tail_plan.py). B4 also serves more
    than 32 global lanes (value observations), each other kernel at most 32.
    B3 and B5 take an image built beforehand in device memory instead (B5
    stages it where its launch plan fits). Where B3, B5 or B6b has no launch
    plan for the shapes (more than 32 global lanes, window offsets that do
    not pack, more candidates than its largest compiled round count), the
    route is the non-fused path (gate_route), so every config the fused
    gates admit runs on the card.

    obs_buf: optional carried uint8[E, A, T, 3] buffer from the previous
    step or reset. On the v2 and v3 routes (B1-B3, B6a, B6b) token ranks at
    or past the tail's proven prefix width OUT_W are impossible (obs_caps
    window bound), so when a buffer is given only its first OUT_W token
    slots are rewritten, IN PLACE, and the buffer itself is returned; any
    other buffer must already hold EMPTY bytes past the prefix. The v1 routes (B4, B5)
    write all T token slots into a new tensor, as the reference does.

    obs_fn.tail is the kernel's wrapper; obs_fn.tail_inputs(state) gives its
    keyword arguments for ``state`` but out_w and wide, which are
    obs_fn.out_w and obs_fn.wide (None on the v1 and v3 routes, whose
    wrappers take no packing)."""
    if obs_tail not in OBS_TAILS:
        raise ValueError(f"obs_tail must be one of {OBS_TAILS}, not {obs_tail!r}")
    if static_mask is not None and static_bg is None:
        raise ValueError("static_mask is the static background's: give it with static_bg")
    A = program.num_agents
    T = program.num_tokens
    feat = program.feature_ids
    H, W = program.height, program.width
    OH, OW = program.obs_height, program.obs_width
    K = len(program.window_offsets)
    hr, wr = OH // 2, OW // 2
    base = program.token_value_base
    caps = compute_obs_caps(program)
    stage1 = make_stage1(program)
    S = stage1.num_slots
    cand_feat, _ = _candidate_features(program)

    # ---- window geometry: Manhattan-order offsets -> (u, v, loc) ----
    off = np.array(program.window_offsets, dtype=np.int32)  # [K, 2] (dr, dc)
    uv_of_k = np.stack([off[:, 0] + hr, off[:, 1] + wr], axis=1)
    loc_k = np.array([pack_coordinate(u, v) for u, v in uv_of_k], dtype=np.int32)

    # ---- global slots (order: mettagrid_c.cpp:700-752) ----
    g = program.global_obs
    global_slots = [
        name
        for name, on in (
            ("epct", g.episode_completion_pct),
            ("last_action", g.last_action),
            ("last_action_move", g.last_action_move),
            ("last_reward", g.last_reward),
            ("lp_ew", g.local_position),
            ("lp_ns", g.local_position),
        )
        if on
    ]
    G = len(global_slots)
    GP = G + sum(len(fids) for _, fids, _ in program.value_obs)  # global lanes incl. value digits
    global_fids = {
        "epct": feat.episode_completion_pct,
        "last_action": feat.last_action,
        "last_action_move": feat.last_action_move,
        "last_reward": feat.last_reward,
        "lp_ew": max(feat.lp_east, feat.lp_west),
        "lp_ns": max(feat.lp_north, feat.lp_south),
    }

    # ---- the gates (reference obs.py:474-579) ----
    OWS = OW * S
    KS = K * S
    KS_pad2 = ((G + KS + 127) // 128) * 128  # v2 candidate lanes incl. globals
    has_aoe_mask = mutfields.has_aoe_mask(program)
    feat_max = max([int(np.max(cand_feat)) if cand_feat.size else 0] + [int(global_fids[s]) for s in global_slots])
    wide = KS_pad2 > 512
    v2_common = (
        not has_aoe_mask
        and not program.value_obs
        and all(slot in _ALWAYS_VALID_GLOBALS for slot in global_slots)
        and all(int(loc) != 0xFF for loc in loc_k)
        and OH <= _V2_RPE
        and OWS <= 128
    )
    v2_ok = v2_common and ((not wide and feat_max < 128) or (wide and feat_max < 64 and KS_pad2 <= 1024))
    # Both fused tails read window rows of at most 128 lanes, and neither
    # emits the AOE mask (reference obs.py:857-866).
    fused = not has_aoe_mask and OWS <= 128
    # v2: provable output-prefix width, ranks >= G + max_window_tokens never occur.
    OUT_W = min(KS_pad2, max(((min(G + max_window_tokens(program, caps, K), T) + 127) // 128) * 128, 128))
    # v1: the budget, clamped at the candidate lanes (pallas_kernels.py:252).
    T_pad = min(((T + 127) // 128) * 128, GP + ((KS + 127) // 128) * 128)
    RP_f = ((max(OH, 8) + 7) // 8) * 8
    HP_f = ((max(H + OH, H + RP_f, H - 1 + _V2_RPE) + 7) // 8) * 8
    WPC_f = (((W + OW) * S + 127) // 128) * 128
    # v3: paired rows per parity region (reference obs.py:588, whose +16
    # rows of slack served its compiler's 16-row loads; kept so the paired
    # layout is the reference's).
    HP2 = (((H - 1) // 2 + 16) + 7) // 8 * 8
    v3 = obs_tail == "v3" and v2_ok and not wide and 2 * OWS <= 128 and OH <= 15 and hr >= 1
    static = static_bg is not None
    route = gate_route(v2_ok, static, fused, v3, A, GP, K, S, HP_f, WPC_f, HP2, OUT_W if v2_ok else T_pad)

    dev = static_bg.device if static else resolve_device(device)
    geom = torch.from_numpy(
        np.concatenate([uv_of_k, loc_k[:, None]], axis=1).astype(np.int32)
    ).to(dev)
    slot_range = torch.arange(S, dtype=torch.int32, device=dev)

    def global_plus(state: EnvState):
        """int32[E, A, GP]: the +1-encoded global words fid << 8 | value, 0
        where the token is absent (reference _global_tokens,
        _all_global_words and _global_plus, obs.py:453-472, 660-663,
        1340-1388)."""
        E = state.obj_type.shape[0]
        step = state.step_count[:, None]
        agent_r = state.obj_r[:, :A]
        agent_c = state.obj_c[:, :A]
        cols = []

        def word(fid, val, ok=None):
            w = (((fid << 8) | (val & 0xFF)) & 0xFFFF) + 1
            cols.append(w if ok is None else torch.where(ok, w, 0))

        for slot in global_slots:
            fid = global_fids[slot]
            if slot == "epct":
                if program.max_steps > 0:
                    pct = torch.where(
                        step >= program.max_steps, 255,
                        torch.div(256 * step, program.max_steps, rounding_mode="floor"),
                    )
                else:
                    pct = torch.zeros_like(step)
                word(fid, pct.expand(E, A))
            elif slot == "last_action":
                word(fid, state.agent_last_action)
            elif slot == "last_action_move":
                moved = (agent_r != state.agent_prev_r) | (agent_c != state.agent_prev_c)
                word(fid, moved.to(torch.int32))
            elif slot == "last_reward":
                word(fid, torch.round(state.rewards * 100.0).to(torch.int32))
            else:  # local position: absent on the spawn row / column
                east_west = slot == "lp_ew"
                d = agent_c - state.agent_spawn_c if east_west else state.agent_spawn_r - agent_r
                hi, lo = (feat.lp_east, feat.lp_west) if east_west else (feat.lp_north, feat.lp_south)
                fid_d = torch.where(d > 0, hi, lo).to(torch.int32)
                word(fid_d, d.abs().clamp(max=255), d != 0)
        if program.value_obs:
            from mettagrid_tpu_torch.engine.exec import eval_value

            slots = torch.arange(A, dtype=torch.int32, device=dev)[None, :].expand(E, A)
            for _name, fids, cv in program.value_obs:
                amount = eval_value(program, state, cv, slots, None, draws).clamp(min=0.0).floor().to(torch.int32)
                for p, fid in enumerate(fids):
                    div = base**p
                    digit = torch.remainder(torch.div(amount, div, rounding_mode="floor"), base)
                    word(fid, digit, amount >= max(div, 1))
        if not cols:
            return torch.zeros((E, A, 0), dtype=torch.int32, device=dev)
        return torch.stack(cols, dim=-1).to(torch.int32).contiguous()

    def plus_words(tok, cnt):
        """+1-encoded token words: tok + 1 on the cnt live slots, 0 after."""
        return tok + (slot_range < cnt[..., None]).to(torch.int32)

    def padded(cells):
        """Cell images int32[B, H+1, W, S+1] as +1-encoded padded images
        int32[B, HP_f, WPC_f] (reference obs.py:1159-1170)."""
        B = cells.shape[0]
        body = plus_words(cells[..., :S], cells[..., S])[:, :H].reshape(B, H, W * S)
        out = torch.zeros((B, HP_f, WPC_f), dtype=torch.int32, device=cells.device)
        out[:, hr : hr + H, wr * S : (wr + W) * S] = body
        return out

    def agent_tokens(state: EnvState):
        """Stage 1 over the agents' slots."""
        E = state.obj_type.shape[0]
        slots_a = torch.arange(A, dtype=torch.int32, device=dev)[None, :].expand(E, A)
        return stage1(
            state.obj_type[:, :A], state.obj_vibe[:, :A], state.obj_tags[:, :A],
            state.obj_inv[:, :A], state.obj_alive[:, :A],
            torch.ones((E, A), dtype=torch.bool, device=dev),  # slots < A are agents
            state.agent_group, slots_a,
        )

    def agent_inputs(state: EnvState) -> dict:
        """Window starts and the agents' image positions and +1-encoded words."""
        agent_r = state.obj_r[:, :A]
        agent_c = state.obj_c[:, :A]
        tok_a, cnt_a = agent_tokens(state)
        return dict(
            row0=agent_r.contiguous(),
            lane0=(agent_c * S).contiguous(),
            rext=(agent_r + hr).contiguous(),
            lext=((agent_c + wr) * S).contiguous(),
            words=plus_words(tok_a, cnt_a).contiguous(),
        )

    def object_tokens(state: EnvState):
        """Stage 1 over every object slot (reference obs.py:1023-1071, 1102-1120);
        dead objects get no tokens."""
        E, N = state.obj_type.shape
        slots_n = torch.arange(N, dtype=torch.int32, device=dev)[None, :].expand(E, N)
        return stage1(
            state.obj_type, state.obj_vibe, state.obj_tags, state.obj_inv, state.obj_alive,
            slots_n < A,  # slots < A are agents
            torch.nn.functional.pad(state.agent_group, (0, N - A)), slots_n,
        )

    def cell_image(state: EnvState):
        """Raw token words and counts per cell of every object, int32[E,
        H+1, W, S+1]."""
        tok_n, cnt_n = object_tokens(state)
        return _scatter_cells(tok_n, cnt_n, state.obj_alive, state.obj_r, state.obj_c, H, W)

    if static and route != "nonfused":
        # ---- prepadded +1-encoded static pool, int32[P, HP_f, WPC_f] ----
        static_imgp = padded(static_bg)

        def image(state: EnvState):
            """Each env's padded image, int32[E, HP_f, WPC_f]: its pooled map
            plus the agents' words (reference obs.py:996-1021)."""
            E = state.obj_type.shape[0]
            a = agent_inputs(state)
            img = static_imgp[state.map_idx.long()]
            add_words(img.view(E, HP_f * WPC_f), HP_f, WPC_f, a["rext"], a["lext"], a["words"])
            return img, a
    elif not static:

        def image(state: EnvState):
            """Each env's padded image, int32[E, HP_f, WPC_f], from the cell
            image of every object (reference obs.py:1102-1120, 1159-1170)."""
            a = dict(row0=state.obj_r[:, :A].contiguous(), lane0=(state.obj_c[:, :A] * S).contiguous())
            return padded(cell_image(state)), a

    # ---- the non-fused path (reference obs.py:1073-1271) ----
    M = 1 if has_aoe_mask else 0  # the AOE mask word leads each cell's candidates
    Ch = S + 1 + M  # image channels: S token words, the count, the winning tag + 1
    HP_n = ((H + OH + 7) // 8) * 8
    WPC_n = (((W + OW) * Ch + 127) // 128) * 128
    loc_t = torch.from_numpy(loc_k).to(dev)
    if has_aoe_mask:
        check_territories(program)
    mask_per_step = has_aoe_mask and static_mask is None
    if mask_per_step:
        cell_r = torch.arange(H, dtype=torch.int32, device=dev).repeat_interleave(W)  # [H*W]
        cell_c = torch.arange(W, dtype=torch.int32, device=dev).repeat(H)

    def body(img):
        """The map's cells of padded interleaved images img int32[B, HP_n,
        WPC_n], a view [B, H, W, Ch]."""
        return img[:, hr : hr + H, wr * Ch : (wr + W) * Ch].unflatten(-1, (W, Ch))

    if static and route == "nonfused":
        # ---- the interleaved static pool, int32[P, HP_n, WPC_n]: the pooled
        # maps' words and counts, and with static_mask their winning tags ----
        static_imgn = torch.zeros((static_bg.shape[0], HP_n, WPC_n), dtype=torch.int32, device=dev)
        body(static_imgn)[..., : S + 1] = static_bg[:, :H]
        if static_mask is not None:
            body(static_imgn)[..., S + 1] = static_mask

    def window_inputs(state: EnvState) -> dict:
        """B7's arguments: the padded interleaved image int32[E, HP_n, WPC_n]
        of Ch channels per cell (reference obs.py:1126-1145, 1174-1181) and
        the agents' window starts. Over a static background each env's pooled
        image plus the agents' words and counts, else every object's."""
        E = state.obj_type.shape[0]
        agent_r, agent_c = state.obj_r[:, :A], state.obj_c[:, :A]
        if static:
            img = static_imgn[state.map_idx.long()]
            tok_a, cnt_a = agent_tokens(state)  # a dead agent's are 0
            add_words(img.view(E, HP_n * WPC_n), HP_n, WPC_n, agent_r + hr, (agent_c + wr) * Ch,
                      torch.cat([tok_a, cnt_a[..., None]], dim=-1))
        else:
            img = torch.zeros((E, HP_n, WPC_n), dtype=torch.int32, device=dev)
            body(img)[..., : S + 1] = cell_image(state)[:, :H]
        if mask_per_step:
            pts = (cell_r.expand(E, H * W), cell_c.expand(E, H * W))
            body(img)[..., S + 1] = (winning_tags(program, state, *pts) + 1).view(E, H, W)
        return dict(img=img, row0=agent_r.contiguous(), lane0=(agent_c * Ch).contiguous(), geom=geom, Ch=Ch)

    def candidate_words(state: EnvState, win) -> torch.Tensor:
        """Each agent's candidate words int32[E, A, G + K*(M+S)], -1 where
        invalid (stage 4, reference obs.py:1213-1245): the globals, then per
        window cell the AOE mask word and the token words, each with its
        location byte at bit 16."""
        E = win.shape[0]
        words = win[..., :S]
        ok = slot_range < win[..., S, None]  # [E, A, K, S]
        if has_aoe_mask:
            wt = win[..., S + 1] - 1  # the winning tag, -1 for none
            friendly = torch.gather(state.obj_tags[:, :A], 2, wt.clamp(0, program.num_tags - 1).long())
            # neutral 0, friendly 1 (the observer has the winning tag), enemy 2
            mask_val = torch.where(wt >= 0, torch.where(friendly, 1, 2), 0).to(torch.int32)
            words = torch.cat([((feat.aoe_mask << 8) | mask_val)[..., None], words], dim=-1)
            ok = torch.cat([(mask_val != 0)[..., None], ok], dim=-1)
        cells = torch.where(ok, words | (loc_t[:, None] << 16), -1).reshape(E, A, -1)
        gplus = global_plus(state)
        gw = torch.where(gplus > 0, (gplus - 1) | (GLOBAL_LOCATION << 16), -1)
        return torch.cat([gw, cells], dim=-1)

    def compact_inputs(state: EnvState) -> dict:
        """B8's arguments: the candidate words of every agent as rows."""
        E = state.obj_type.shape[0]
        words = candidate_words(state, window_slices(**window_inputs(state)))
        return dict(words=words.reshape(E * A, -1), T=T)

    if route in ("B1", "B4"):
        tail = obs_tail_static_v2 if route == "B1" else obs_tail_static_v1
        front = "gplus" if route == "B1" else "gwords"

        def tail_inputs(state: EnvState) -> dict:
            return dict(
                static_imgp=static_imgp, map_idx=state.map_idx.contiguous(), **agent_inputs(state),
                **{front: global_plus(state)}, geom=geom,
            )
    elif route == "B2":
        tail = obs_tail_dynobj_v2

        def tail_inputs(state: EnvState) -> dict:
            tok_n, cnt_n = object_tokens(state)
            return dict(
                rext=(state.obj_r + hr).contiguous(),
                lext=((state.obj_c + wr) * S).contiguous(),
                words=plus_words(tok_n, cnt_n).contiguous(),
                row0=state.obj_r[:, :A].contiguous(),
                lane0=(state.obj_c[:, :A] * S).contiguous(),
                gplus=global_plus(state),
                geom=geom,
                HP=HP_f,
                WPC=WPC_f,
            )
    elif route == "B6a":
        tail = obs_tail_static_v3
        static_l, static_r = pair_rows(static_imgp, HP2)

        def tail_inputs(state: EnvState) -> dict:
            return dict(
                static_l=static_l, static_r=static_r, map_idx=state.map_idx.contiguous(), **agent_inputs(state),
                gplus=global_plus(state), geom=geom,
            )
    elif route == "B6b":  # the image built here and row-paired, read by the kernel from device memory
        tail = obs_tail_dyn_v3

        def tail_inputs(state: EnvState) -> dict:
            img, a = image(state)
            imgp_l, imgp_r = pair_rows(img, HP2)
            return dict(
                imgp_l=imgp_l, imgp_r=imgp_r, row0=a["row0"], lane0=a["lane0"], gplus=global_plus(state),
                geom=geom, S=S,
            )
    elif route in ("B3", "B5"):  # the image built here, read by the kernel from device memory
        tail = obs_tail_dyn_v2 if route == "B3" else obs_tail_v1
        front = "gplus" if route == "B3" else "gwords"

        def tail_inputs(state: EnvState) -> dict:
            img, a = image(state)
            return dict(
                imgp=img, row0=a["row0"], lane0=a["lane0"], **{front: global_plus(state)}, geom=geom, S=S,
            )

    def unpack_v2(out_words, obs_buf):
        """v2 words (loc | feat << 8 | val << 16, 0xFFFFFF = empty) to uint8
        [loc, feature, value] triples over the T-token budget."""
        E = out_words.shape[0]
        ow = min(out_words.shape[-1], T)
        # Little-endian bytes of each word are exactly (loc, feature, value, 0).
        triples = out_words[..., :ow].contiguous().view(torch.uint8).reshape(E, A, ow, 4)[..., :3]
        if ow == T:
            return triples.contiguous()
        if (
            obs_buf is not None
            and tuple(obs_buf.shape) == (E, A, T, 3)
            and obs_buf.dtype == torch.uint8
            and obs_buf.device == out_words.device
        ):
            out = obs_buf
        else:
            out = torch.full((E, A, T, 3), EMPTY_TOKEN_BYTE, dtype=torch.uint8, device=out_words.device)
        out[:, :, :ow] = triples
        return out

    def unpack_v1(out_words):
        """v1 words ((feat << 8 | val) | loc << 16, -1 = empty) to uint8
        [loc, feature, value] triples over all T token slots (reference
        _unpack_words with empty_mapped=False, obs.py:665-721)."""
        E = out_words.shape[0]
        w = out_words[..., :T]
        if w.shape[-1] < T:
            w = torch.nn.functional.pad(w, (0, T - w.shape[-1]), value=-1)
        # Byte-swap so the little-endian bytes read (w >> 16, w >> 8, w) & 0xFF;
        # -1 (empty) gives 0xFF in each, the EMPTY token.
        swapped = ((w & 0xFF) << 16) | (w & 0xFF00) | ((w >> 16) & 0xFF)
        return swapped.view(torch.uint8).reshape(E, A, T, 4)[..., :3].contiguous()

    if route == "nonfused":

        def obs_fn(state: EnvState, obs_buf=None):
            E = state.obj_type.shape[0]
            args = compact_inputs(state)
            attempted = (args["words"] >= 0).sum(dim=-1, dtype=torch.int32).view(E, A)
            return unpack_v1(compact_rows(**args).view(E, A, T)), attempted

        tail = tail_inputs = None
        obs_fn.out_w, obs_fn.wide = T, None
        obs_fn.window_inputs, obs_fn.compact_inputs = window_inputs, compact_inputs
    elif route in ("B1", "B2", "B3"):

        def obs_fn(state: EnvState, obs_buf=None):
            out_words, attempted = tail(**tail_inputs(state), out_w=OUT_W, wide=wide)
            return unpack_v2(out_words, obs_buf), attempted

        obs_fn.out_w, obs_fn.wide = OUT_W, wide
    elif route in ("B6a", "B6b"):

        def obs_fn(state: EnvState, obs_buf=None):
            out_words, attempted = tail(**tail_inputs(state), out_w=OUT_W)
            return unpack_v2(out_words, obs_buf), attempted

        obs_fn.out_w, obs_fn.wide = OUT_W, None
    else:

        def obs_fn(state: EnvState, obs_buf=None):
            out_words, attempted = tail(**tail_inputs(state), out_w=T_pad)
            return unpack_v1(out_words), attempted

        obs_fn.out_w, obs_fn.wide = T_pad, None

    obs_fn.tail = tail
    obs_fn.tail_inputs = tail_inputs
    obs_fn.route = route
    # The shapes a tail kernel is planned from (the padded image's, the
    # global lanes, the window cells and the token slots per cell; on the v3
    # routes also the paired rows per parity region, HP2).
    obs_fn.tail_shapes = dict(HP=HP_f, WPC=WPC_f, G=GP, K=K, S=S, **({"HP2": HP2} if v3 else {}))
    return obs_fn
