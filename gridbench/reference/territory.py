"""The territory game in plain PyTorch (on the CPU, integer arithmetic), for
the sampled envs of a run.

The rules are upstream's (Metta-AI/mettagrid): the arena game's step
(mettagrid_c.cpp, as ``reference/arena.py`` states it: moves in the
traffic's order, coverage, visited staleness, token stats, rewards, episode
ends) plus the territory game of docs/territory.md, core/territory_tracker.cpp
and core/aoe_tracker.cpp, as the configuration file
(``configs/<name>.json``) states them. Everything is derived here from that
file and the map grids; of ``reference/arena.py`` only its helpers are used
(the vision window in Manhattan order, the feature ids, a map's cells).
Nothing of the program under test is imported.

* Tags: ``type:<t>`` of every type and the tags the file gives, ids in name
  order. A shared-tag-prefix filter passes when actor and target hold a
  common tag whose name starts with the prefix.
* Territory: a source (an alive object whose type controls the territory and
  holds a tag named ``<prefix>:...``) carries its first such tag (lowest id)
  and projects on a point at squared distance d2 the integer influence
  max(0, 1024 * strength - decay * isqrt(1024**2 * d2)). A point's owner is
  the tag whose influence sum is largest, if it is above 0 and no other tag
  ties it; else the point is neutral.
* The territory phase, per agent, per territory: where the owner of the
  agent's cell changed, on_exit fires for the old owner, then on_enter for the
  new; presence fires each tick in owned territory. Each handler's actor is a
  proxy that carries only the owning tag.
* AOE: each source of an AOE reaches the agents at squared distance up to
  radius**2 (itself excepted unless effect_self) that pass its filter (actor
  the source, target the agent). Per agent, the sources in slot order (their
  registration order): entering a source's reach applies its presence deltas
  at once, leaving applies their negation, each clamped on its own; the
  per-tick deltas of every source that reaches the agent are summed and
  applied once, clamped (the deferred batch).
* A resource delta clamps the agent's amount to [0, its limit]
  (``inventory_limits``, else ``inventory_default_limit``).
* A step: auto-reset, the step count, the rewards cleared, the moves, then
  the AOE, then the territory, then the observations, the coverage,
  visited-staleness and token stats, the rewards (the change of a weighted
  inventory sum) and the episode end at ``max_steps``. The observations come
  before the rewards, so their ``last_reward`` reads the cleared rewards.
* An observation is the arena's, but each cell of the window that is on the
  map and owned (the first territory owning it) leads its tokens with the
  ``aoe_mask`` token: 1 where the observer holds the owning tag, else 2. The
  feature follows the inventory features and, where ``protocol_details_obs``
  is on, the 2R protocol features.

Departures and readings:

* Upstream counts an agent's inventory changes as stats (``heart.gained``,
  ``armor.lost``, ...); the program keeps them in lanes the harness does not
  read back, so they are not among the results.
* The upstream per-source order of presence deltas is read as slot order;
  ``clamped_presence`` counts the presence deltas a clamp cut, where that
  order (and not only the net count) decides the result.
* Objects other than agents never move, change or die here (no handler
  writes them): their state is the map's, set at each load.
* Each resource's limit is a group of its own, as every limit of the file
  names one resource.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gridbench.reference.arena import (
    EMPTY,
    GLOBAL_FEATURES,
    GLOBAL_LOCATION,
    MOVES,
    cells,
    feature_ids,
    inventory_tokens,
    window_offsets,
)

I64 = torch.int64
SCALE = 1024


def tensor(x, dtype=I64):
    return torch.as_tensor(x, dtype=dtype)


class Rules:
    """What the configuration file fixes: ids, tables, the window, the
    territory and the AOE."""

    def __init__(self, spec: dict, max_steps: int):
        obs = spec["obs"]
        self.A = spec["num_agents"]
        self.T = obs["num_tokens"]
        self.base = obs["token_value_base"]
        self.oh, self.ow = obs["height"], obs["width"]
        self.max_steps = max_steps
        self.resources = list(spec["resources"])
        self.R = len(self.resources)
        rid = {r: i for i, r in enumerate(self.resources)}
        self.n_inv = inventory_tokens(65535, self.base)
        self.fid = feature_ids(self.resources, self.base)
        self.mask_feature = len(self.fid) + (2 * self.R if obs.get("protocol_details_obs") else 0)
        self.globals = [name for name, flag in GLOBAL_FEATURES if obs["global_obs"][flag]]

        types = {"agent": spec["agent"], **spec["objects"]}
        self.type_names = list(types)
        self.tag_names = sorted({f"type:{t}" for t in types} | {g for c in types.values() for g in c.get("tags", ())})
        tag_id = {t: i for i, t in enumerate(self.tag_names)}
        self.type_tags = torch.zeros(len(types), len(self.tag_names), dtype=torch.bool)
        for k, (name, c) in enumerate(types.items()):
            for g in [f"type:{name}", *c.get("tags", ())]:
                self.type_tags[k, tag_id[g]] = True
        self.type_vibe = tensor([c.get("vibe", 0) for c in types.values()])
        self.type_tag_ids = [torch.nonzero(row).flatten().tolist() for row in self.type_tags]
        self.type_vibe_ids = self.type_vibe.tolist()
        self.type_inv = tensor([[c.get("inventory", {}).get(r, 0) for r in self.resources] for c in types.values()])
        # Tokens an object of each type has before its inventory: its tags,
        # its vibe, and for an agent its group and id.
        self.type_fixed_tokens = self.type_tags.sum(1) + (self.type_vibe != 0) + tensor([2] + [0] * (len(types) - 1))

        agent = spec["agent"]
        self.group = agent["group"]
        self.limit = tensor([agent["inventory_limits"].get(r, agent["inventory_default_limit"])
                             for r in self.resources])
        self.reward_w = tensor([agent["rewards"].get(r, 0.0) for r in self.resources], torch.float64)

        self.actions = list(spec["actions"])
        self.move_d = tensor([MOVES.get(a, (0, 0)) for a in self.actions])
        self.is_move = tensor([a in MOVES for a in self.actions], torch.bool)
        families = list(dict.fromkeys(a.split("_")[0] for a in self.actions))
        self.stat_names = ([f"action.{f}.success" for f in families] + [f"action.{f}.failed" for f in families]
                           + ["action.failed", "action.invalid_index", "status.max_steps_without_motion"])
        fam = tensor([families.index(a.split("_")[0]) for a in self.actions])
        self.succ_stat, self.fail_stat = fam, fam + len(families)
        self.stat_failed, self.stat_swm = 2 * len(families), 2 * len(families) + 2
        off = window_offsets(self.oh, self.ow)
        self.off_r = tensor([o[0] for o in off])
        self.off_c = tensor([o[1] for o in off])
        self.loc = ((self.off_r + self.oh // 2) << 4) | (self.off_c + self.ow // 2)

        def prefix_mask(prefix: str) -> torch.Tensor:
            return tensor([t.startswith(prefix) for t in self.tag_names], torch.bool)

        def deltas(d: dict) -> list:
            return [(rid[r], v) for r, v in d.items()]

        def handler(rule: dict) -> dict:
            mask = prefix_mask(rule["shared_tag_prefix"]) if "shared_tag_prefix" in rule else None
            return {"filter": mask, "deltas": deltas(rule["deltas"])}

        # The AOE specs, each of one source type.
        self.aoes = []
        for k, c in enumerate(types.values()):
            for rule in c.get("aoes", {}).values():
                self.aoes.append({"type": k, "radius": rule["radius"], "effect_self": rule["effect_self"],
                                  **handler(rule), "presence": deltas(rule["presence_deltas"])})
        # The territories: the prefix's tags, each type's strength and decay.
        self.territories = []
        for name, t in spec["territories"].items():
            strength, decay = torch.zeros(len(types), dtype=I64), torch.zeros(len(types), dtype=I64)
            for k, c in enumerate(types.values()):
                for tc in c.get("territory_controls", ()):
                    if tc["territory"] == name:
                        strength[k], decay[k] = tc["strength"], tc["decay"]
            prefix = t["tag_prefix"] if t["tag_prefix"].endswith(":") else t["tag_prefix"] + ":"
            tags = [i for i, g in enumerate(self.tag_names) if g.startswith(prefix) or g == t["tag_prefix"]]
            self.territories.append({"tags": tensor(tags), "strength": strength, "decay": decay,
                                     **{kind: handler(t[kind]) for kind in ("on_exit", "on_enter", "presence")}})

    def object_tokens(self, type_id: int, inv: list, slot: int) -> list[tuple[int, int]]:
        """(feature, value) of one object's tokens, in their order (``inv``: its
        amounts as Python ints)."""
        toks = [(self.fid["tag"], t) for t in self.type_tag_ids[type_id]]
        vibe = self.type_vibe_ids[type_id]
        if vibe != 0:
            toks.append((self.fid["vibe"], vibe))
        for r, name in enumerate(self.resources):
            for p in range(self.n_inv):
                if inv[r] >= self.base ** p:
                    toks.append((self.fid[f"inv:{name}" if p == 0 else f"inv:{name}:p{p}"],
                                 (inv[r] // self.base ** p) % self.base))
        if slot < self.A:
            toks += [(self.fid["agent:group"], self.group), (self.fid["agent_id"], slot)]
        return toks


class PoolMap:
    """One pool map's start state, from its grid of cell names."""

    def __init__(self, rules: Rules, grid):
        H, W = np.shape(grid)
        flat, agents, objects = cells(grid)
        if len(agents) != rules.A:
            raise ValueError(f"map has {len(agents)} agent cells, expected {rules.A}")
        unknown = set(flat[objects]) - set(rules.type_names)
        if unknown:
            raise ValueError(f"map cells of no configured type: {sorted(unknown)}")
        order = np.concatenate([agents, objects])
        self.N = len(order)
        self.slot_grid = torch.full((H * W,), -1, dtype=I64)
        self.slot_grid[tensor(order)] = torch.arange(self.N)
        self.slot_grid = self.slot_grid.reshape(H, W)
        self.type = tensor([0] * rules.A + [rules.type_names.index(n) for n in flat[objects]])
        self.r, self.c = tensor(order // W), tensor(order % W)


def isqrt_table(n: int) -> torch.Tensor:
    """floor(1024 * sqrt(d2)) = isqrt(1024**2 * d2) for d2 in [0, n]."""
    return tensor([math.isqrt(SCALE * SCALE * d2) for d2 in range(n + 1)])


class Arena:
    """S envs of the territory game, stepped together but each on its own.

    ``grids``: the pool's map grids; ``initial_maps``: int[S], the pool map
    each env starts on. ``clamped_presence`` counts the presence deltas a
    clamp cut (see the module's readings)."""

    def __init__(self, spec: dict, grids, initial_maps, max_steps: int):
        g = self.g = Rules(spec, max_steps)
        self.grids = grids
        self.maps: dict[int, PoolMap] = {}
        S, A = len(initial_maps), g.A
        H, W = (int(x) for x in grids[0].shape)
        self.S, self.H, self.W = S, H, W
        self.N = A + max(len(cells(grid)[2]) for grid in grids)
        self.sd = isqrt_table((H - 1) ** 2 + (W - 1) ** 2)

        def z(*shape, dtype=I64):
            return torch.zeros(shape, dtype=dtype)

        self.grid = torch.full((S, H, W), -1, dtype=I64)
        self.map_idx = z(S)
        self.obj_type = torch.full((S, self.N), -1, dtype=I64)
        self.obj_r, self.obj_c = z(S, self.N), z(S, self.N)
        self.obj_inv = z(S, self.N, g.R)
        self.spawn_r, self.spawn_c = z(S, A), z(S, A)
        self.swm = z(S, A)
        self.last_action = z(S, A)
        self.success = z(S, A, dtype=torch.bool)
        self.stats = z(S, A, len(g.stat_names))
        self.cell = z(S, A, 3)
        self.seen = z(S, A, H * W, dtype=torch.bool)
        self.obj_visited = z(S, self.N)
        # Game stats are float32 counters, as upstream's stats tracker keeps them.
        self.tokens = z(S, 3, dtype=torch.float32)
        self.step_count = z(S)
        self.rewards = z(S, A, dtype=torch.float64)
        self.seen_rewards = z(S, A, dtype=torch.float64)  # the rewards the observations read
        self.reward_prev = z(S, A, dtype=torch.float64)
        self.episode_rewards = z(S, A, dtype=torch.float64)
        self.terminals = z(S, A, dtype=torch.bool)
        self.attempted = z(S, A)
        self.aoe_inside = z(S, len(g.aoes), self.N, A, dtype=torch.bool)
        self.territory_inside = torch.full((S, len(g.territories), A), -1, dtype=I64)
        self.clamped_presence = 0
        for s, m in enumerate(initial_maps):
            self._load(s, int(m))

    # --- state ---

    @property
    def pos_r(self):
        return self.obj_r[:, : self.g.A]

    @property
    def pos_c(self):
        return self.obj_c[:, : self.g.A]

    def _map(self, m: int) -> PoolMap:
        if m not in self.maps:
            self.maps[m] = PoolMap(self.g, self.grids[m])
        return self.maps[m]

    def _load(self, s: int, m: int) -> None:
        """Env s rebuilt from pool map m, with the token stats of the
        observation its construction makes."""
        pm, g = self._map(m), self.g
        n = pm.N
        self.map_idx[s] = m
        self.grid[s] = pm.slot_grid
        self.obj_type[s] = -1
        self.obj_type[s, :n] = pm.type
        self.obj_r[s] = 0
        self.obj_c[s] = 0
        self.obj_r[s, :n], self.obj_c[s, :n] = pm.r, pm.c
        self.obj_inv[s] = 0
        self.obj_inv[s, :n] = g.type_inv[pm.type]
        self.spawn_r[s], self.spawn_c[s] = pm.r[: g.A], pm.c[: g.A]
        for x in (self.swm, self.last_action, self.stats, self.cell, self.obj_visited, self.step_count,
                  self.rewards, self.seen_rewards, self.reward_prev, self.episode_rewards, self.tokens):
            x[s] = 0
        self.success[s] = False
        self.terminals[s] = False
        self.cell[s, :, 1] = 1  # the spawn cell counts as visited
        self.seen[s] = False
        self.seen[s, torch.arange(g.A), pm.r[: g.A] * self.W + pm.c[: g.A]] = True
        self.aoe_inside[s] = False
        self.territory_inside[s] = -1
        self._count_tokens(tensor([s]))

    def _add(self, envs, agents, rid: int, delta) -> torch.Tensor:
        """Adds ``delta`` to resource rid of the agents (flat index lists),
        clamped to [0, limit]; returns the clamped amounts."""
        old = self.obj_inv[envs, agents, rid]
        new = (old + delta).clamp(0, int(self.g.limit[rid]))
        self.obj_inv[envs, agents, rid] = new
        return new

    # --- territory ---

    def owners(self, ti: int, envs, pr, pc) -> torch.Tensor:
        """The tag owning each point (pr, pc int[n, P]) of the envs ``envs``
        in territory ti, int[n, P] (-1 neutral)."""
        t = self.g.territories[ti]
        typ = self.obj_type[envs]
        tk = typ.clamp(min=0)
        tags = self.g.type_tags[tk][..., t["tags"]]  # [n, N, Tt]
        has = tags.any(-1)
        first = tags.to(I64).argmax(-1)  # the source's first prefix tag
        emits = (typ >= 0) & (t["strength"][tk] > 0) & has
        # The sources alone, in slot order (the sums are exact in any order).
        J = int(emits.sum(1).max()) if len(envs) else 0
        src = torch.sort((~emits).to(torch.uint8), dim=1, stable=True).indices[:, :J]

        def pick(x):
            return torch.gather(x, 1, src)

        d2 = (pick(self.obj_r[envs])[:, :, None] - pr[:, None, :]) ** 2 + \
             (pick(self.obj_c[envs])[:, :, None] - pc[:, None, :]) ** 2
        strength, decay = pick(t["strength"][tk]), pick(t["decay"][tk])
        score = (SCALE * strength[:, :, None] - decay[:, :, None] * self.sd[d2]).clamp(min=0)
        score = torch.where(pick(emits)[:, :, None], score, 0)  # [n, J, P]
        first = pick(first)[:, :, None]
        sums = torch.stack([torch.where(first == i, score, 0).sum(1) for i in range(len(t["tags"]))], -1)
        best = sums.max(-1).values
        unique = (sums == best[..., None]).sum(-1) == 1
        return torch.where((best > 0) & unique, t["tags"][sums.argmax(-1)], -1)

    def owner_image(self, envs) -> torch.Tensor:
        """The first owning territory's tag of every cell, int[n, H, W]."""
        n = len(envs)
        rr = torch.arange(self.H).repeat_interleave(self.W).expand(n, -1)
        cc = torch.arange(self.W).repeat(self.H).expand(n, -1)
        win = torch.full((n, self.H * self.W), -1, dtype=I64)
        for ti in range(len(self.g.territories)):
            win = torch.where(win < 0, self.owners(ti, envs, rr, cc), win)
        return win.reshape(n, self.H, self.W)

    def _passes(self, rule: dict, actor_tags, agent_tags) -> torch.Tensor:
        """A handler's filter (None, or the shared tag prefix's mask)."""
        if rule["filter"] is None:
            return torch.ones(agent_tags.shape[:-1], dtype=torch.bool)
        return (actor_tags & agent_tags & rule["filter"]).any(-1)

    def _apply(self, rule: dict, mask) -> None:
        si, ai = torch.nonzero(mask, as_tuple=True)
        for rid, d in rule["deltas"]:
            self._add(si, ai, rid, d)

    def _territory(self) -> None:
        g, S, A = self.g, self.S, self.g.A
        envs = torch.arange(S)
        agent_tags = g.type_tags[self.obj_type[:, :A]]  # [S, A, tags]

        def proxy(tag):
            return (tag[..., None] == torch.arange(len(g.tag_names))) & (tag[..., None] >= 0)

        for ti, t in enumerate(g.territories):
            cur = self.owners(ti, envs, self.pos_r, self.pos_c)
            prev = self.territory_inside[:, ti]
            changed = cur != prev
            for kind, tag, on in (("on_exit", prev, changed & (prev >= 0)), ("on_enter", cur, changed & (cur >= 0)),
                                  ("presence", cur, cur >= 0)):
                self._apply(t[kind], on & self._passes(t[kind], proxy(tag), agent_tags))
            self.territory_inside[:, ti] = cur

    # --- AOE ---

    def _aoe(self) -> None:
        g, S, A = self.g, self.S, self.g.A
        if not g.aoes:
            return
        source_types = tensor(sorted({a["type"] for a in g.aoes}))
        is_source = (self.obj_type[..., None] == source_types).any(-1)  # [S, N]
        J = int(is_source.sum(1).max())
        # Each env's sources in slot order (padded with -1).
        ranked = torch.sort((~is_source).to(torch.uint8), dim=1, stable=True).indices[:, :J]
        src = torch.where(torch.gather(is_source, 1, ranked), ranked, -1)
        envs = torch.arange(S)[:, None].expand(S, A)
        agents = torch.arange(A)[None, :].expand(S, A)
        agent_tags = g.type_tags[self.obj_type[:, :A]]
        pending = torch.zeros((S, A, g.R), dtype=I64)  # the per-tick deltas, applied once
        for j in range(J):
            s = src[:, j]
            sk = s.clamp(min=0)
            stype = torch.where(s >= 0, self.obj_type[torch.arange(S), sk], -1)
            d2 = (self.obj_r[torch.arange(S), sk][:, None] - self.pos_r) ** 2 + \
                 (self.obj_c[torch.arange(S), sk][:, None] - self.pos_c) ** 2
            src_tags = g.type_tags[stype.clamp(min=0)][:, None, :]
            for k, a in enumerate(g.aoes):
                reach = (stype == a["type"])[:, None] & (d2 <= a["radius"] ** 2)
                if not a["effect_self"]:
                    reach &= sk[:, None] != agents
                passes = reach & self._passes(a, src_tags, agent_tags)
                was = self.aoe_inside[torch.arange(S), k, sk] & (s >= 0)[:, None]  # [S, A]
                edge = (passes & ~was).to(I64) - (was & ~passes).to(I64)  # entering +1, leaving -1
                for rid, d in a["presence"]:
                    want = self.obj_inv[:, :A, rid] + d * edge
                    new = self._add(envs.flatten(), agents.flatten(), rid, (d * edge).flatten()).reshape(S, A)
                    self.clamped_presence += int(((edge != 0) & (new != want)).sum())
                for rid, d in a["deltas"]:
                    pending[:, :, rid] += d * passes
                rows = torch.arange(S)[s >= 0]
                self.aoe_inside[rows, k, sk[rows]] = passes[rows]
        for rid in range(g.R):
            on = pending[:, :, rid] != 0
            if on.any():
                si, ai = torch.nonzero(on, as_tuple=True)
                self._add(si, ai, rid, pending[si, ai, rid])

    # --- the arena's rules ---

    def _window(self, img, envs, fill) -> torch.Tensor:
        """img[i, r + dr, c + dc] over the window of every agent of env
        envs[i] (img holds those envs' rows), [n, A, K]; cells off the map
        read ``fill``."""
        g = self.g
        n, H, W = img.shape
        rows = self.pos_r[envs][:, :, None] + g.off_r
        cols = self.pos_c[envs][:, :, None] + g.off_c
        inside = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
        flat = rows.clamp(0, H - 1) * W + cols.clamp(0, W - 1)
        picked = torch.gather(img.reshape(n, 1, -1).expand(n, g.A, H * W), 2, flat)
        return torch.where(inside, picked, fill)

    def _object_token_counts(self, envs) -> torch.Tensor:
        """Tokens of every object of the envs, int[n, N] (0 for an empty slot)."""
        g = self.g
        typ = self.obj_type[envs]
        inv = self.obj_inv[envs]
        digits = sum((inv >= g.base ** p).sum(-1) for p in range(g.n_inv))
        return torch.where(typ >= 0, g.type_fixed_tokens[typ.clamp(min=0)] + digits, 0)

    def _count_tokens(self, envs, slots=None) -> None:
        """Tokens attempted by each agent's observation, and the token stats;
        ``slots``: the envs' windows of object slots, where already read."""
        g = self.g
        if slots is None:
            slots = self._window(self.grid[envs], envs, -1)
        masks = self._window(self.owner_image(envs), envs, -1) >= 0  # an owned cell on the map
        counts = self._object_token_counts(envs)
        per_object = torch.gather(counts, 1, slots.clamp(min=0).flatten(1)).reshape(slots.shape)
        attempted = len(g.globals) + (torch.where(slots >= 0, per_object, 0) + masks.to(I64)).sum(2)
        self.attempted[envs] = attempted
        written = attempted.clamp(max=g.T)
        counts = torch.stack([written.sum(1), (attempted - written).sum(1), (g.T - written).sum(1)], 1)
        self.tokens[envs] = self.tokens[envs] + counts.to(torch.float32)

    def step(self, actions, perm, reset_maps, vibe_actions=None) -> None:
        """One step of every env: actions int[S, A], perm int[S, A] (the agent
        acting at each rank), reset_maps int[S] (the map of an env that
        resets); vibe_actions int[S, A] have to be 0 (noop): the game
        changes no vibe."""
        g, S, A, W = self.g, self.S, self.g.A, self.W
        actions, perm, reset_maps = tensor(actions), tensor(perm), tensor(reset_maps)
        if vibe_actions is not None and bool((tensor(vibe_actions) != 0).any()):
            raise ValueError("the territory game takes no vibe actions")
        for s in torch.nonzero(self.terminals.any(1)).flatten().tolist():
            self._load(s, int(reset_maps[s]))
        self.step_count += 1
        self.rewards = torch.zeros_like(self.rewards)
        if bool(((actions < 0) | (actions >= len(g.actions))).any()):
            raise ValueError("action index out of range")
        ranked = torch.gather(actions, 1, perm)  # the action of the agent at each rank
        dr, dc, is_move = g.move_d[ranked, 0], g.move_d[ranked, 1], g.is_move[ranked]
        envs = torch.arange(S)
        flat = self.grid.view(S, -1)
        moved = torch.zeros((S, A), dtype=torch.bool)
        for i in range(A):  # one rank at a time: a move sees the moves before it
            a = perm[:, i]
            r, c = self.obj_r[envs, a], self.obj_c[envs, a]
            tr, tc = r + dr[:, i], c + dc[:, i]
            ok = is_move[:, i] & (tr >= 0) & (tr < self.H) & (tc >= 0) & (tc < W)
            ok &= flat[envs, (tr * W + tc).clamp(0, self.H * W - 1)] < 0
            m, am = envs[ok], a[ok]
            flat[m, r[ok] * W + c[ok]] = -1
            flat[m, tr[ok] * W + tc[ok]] = am
            self.obj_r[m, am], self.obj_c[m, am] = tr[ok], tc[ok]
            moved[m, am] = True
        ok = ~g.is_move[actions] | moved
        si, ai = torch.meshgrid(torch.arange(S), torch.arange(A), indexing="ij")
        self.stats[si, ai, torch.where(ok, g.succ_stat[actions], g.fail_stat[actions])] += 1
        self.stats[:, :, g.stat_failed] += (~ok).to(I64)
        swm = torch.where(moved, 0, self.swm + 1)
        top = self.stats[:, :, g.stat_swm]
        self.stats[:, :, g.stat_swm] = torch.where(~moved & (swm > top), swm, top)
        self.swm = swm
        self.last_action = torch.where(ok, actions, 0)
        self.success = ok
        self._aoe()
        self._territory()
        slots = self._window(self.grid, envs, -1)
        self._count_tokens(envs, slots)
        self._coverage()
        self._visited(slots)
        self.seen_rewards = self.rewards.clone()
        value = (self.obj_inv[:, :A].to(torch.float64) * g.reward_w).sum(2)
        self.rewards = value - self.reward_prev
        self.reward_prev = value
        self.episode_rewards += self.rewards
        self.terminals |= (self.step_count >= g.max_steps)[:, None]

    def _coverage(self) -> None:
        cell = self.pos_r * self.W + self.pos_c
        seen = torch.gather(self.seen, 2, cell[:, :, None])[:, :, 0]
        self.cell[:, :, 1] += (~seen).to(I64)
        self.seen.scatter_(2, cell[:, :, None], True)
        dist = (self.pos_r - self.spawn_r).abs() + (self.pos_c - self.spawn_c).abs()
        self.cell[:, :, 2] = torch.maximum(self.cell[:, :, 2], dist)

    def _visited(self, slots) -> None:
        """Each object in some agent's vision is claimed by the agent of the
        lowest slot that sees it, which adds the steps since the object was
        last claimed."""
        S, A = self.S, self.g.A
        first = torch.full((S, self.N), A, dtype=I64)
        who = torch.arange(A)[None, :, None].expand_as(slots)
        first.scatter_reduce_(1, slots.clamp(min=0).flatten(1), torch.where(slots >= 0, who, A).flatten(1), "amin")
        cs, co = torch.nonzero(first < A, as_tuple=True)
        self.cell[:, :, 0].index_put_((cs, first[cs, co]), self.step_count[cs] - self.obj_visited[cs, co],
                                      accumulate=True)
        self.obj_visited[cs, co] = self.step_count[cs]

    # --- outputs ---

    def observations(self) -> torch.Tensor:
        """uint8[S, A, T, 3]: each agent's observation after the last step."""
        g = self.g
        out = torch.full((self.S, g.A, g.T, 3), EMPTY, dtype=torch.uint8)
        owner = self.owner_image(torch.arange(self.S)).tolist()
        grid, typ, inv = self.grid.tolist(), self.obj_type.tolist(), self.obj_inv.tolist()
        rows, cols = self.pos_r.tolist(), self.pos_c.tolist()
        last_action, steps = self.last_action.tolist(), self.step_count.tolist()
        rewards = torch.round(self.seen_rewards.to(torch.float32) * 100.0).to(I64).tolist()
        window = list(zip(g.off_r.tolist(), g.off_c.tolist(), g.loc.tolist()))
        tags = g.type_tags.tolist()
        for s in range(self.S):
            pct = 255 if steps[s] >= g.max_steps else (256 * steps[s]) // g.max_steps
            tokens = {}  # slot -> its (feature, value) tokens

            def of(slot):
                if slot not in tokens:
                    tokens[slot] = g.object_tokens(typ[s][slot], inv[s][slot], slot)
                return tokens[slot]

            for a in range(g.A):
                values = {"episode_completion_pct": pct, "last_action": last_action[s][a],
                          "last_reward": rewards[s][a]}
                toks = [(GLOBAL_LOCATION, g.fid[name], values[name] & 0xFF) for name in g.globals]
                mine = tags[typ[s][a]]
                r, c = rows[s][a], cols[s][a]
                for dr, dc, loc in window:
                    rr, cc = r + dr, c + dc
                    if not (0 <= rr < self.H and 0 <= cc < self.W):
                        continue
                    tag = owner[s][rr][cc]
                    if tag >= 0:
                        toks.append((loc, g.mask_feature, 1 if mine[tag] else 2))
                    slot = grid[s][rr][cc]
                    if slot >= 0:
                        toks += [(loc, f, v & 0xFF) for f, v in of(slot)]
                toks = toks[: g.T]
                if toks:
                    out[s, a, : len(toks)] = torch.tensor(toks, dtype=torch.uint8)
        return out

    def outputs(self) -> dict:
        """The last step's outputs for the S envs, as numpy arrays."""
        return {
            "observations": self.observations().numpy(),
            "tokens_attempted": self.attempted.numpy().copy(),
            "rewards": self.rewards.numpy().copy(),
            "terminals": self.terminals.numpy().copy(),
            "truncations": torch.zeros_like(self.terminals).numpy(),
        }

    def results(self) -> dict:
        """The named results a run compares, for the S envs (numpy)."""
        res = {
            **self.outputs(),
            "positions": torch.stack([self.pos_r, self.pos_c], -1).numpy().copy(),
            "grid": self.grid.numpy().copy(),
            "episode_rewards": self.episode_rewards.numpy().copy(),
            "step_count": self.step_count.numpy().copy(),
            "map_idx": self.map_idx.numpy().copy(),
            "action_success": self.success.numpy().copy(),
        }
        for k, name in enumerate(self.g.stat_names):
            res[f"agent_stat:{name}"] = self.stats[:, :, k].numpy().copy()
        for k, name in enumerate(("cell.visited", "cell.unique_visited", "cell.max_distance_from_spawn")):
            res[f"agent_stat:{name}"] = self.cell[:, :, k].numpy().copy()
        for k, name in enumerate(("tokens_written", "tokens_dropped", "tokens_free_space")):
            res[f"game_stat:{name}"] = self.tokens[:, k].numpy().copy()
        return res
