"""The arena game in plain NumPy, for the sampled envs of a run.

The rules are the upstream engine's (Metta-AI/mettagrid, mettagrid_c.cpp's
step, core/observation_shape.cpp, systems/packed_coordinate.hpp), as the
configuration file (``configs/<name>.json``) states them. Everything is
derived here from that file and the map grids: slots, feature and tag ids,
the start state, the vision window and the token layout. Nothing of the
program under test is imported.

* A map is a grid of cell names. Scanned row-major, agent cells take slots
  0..A-1 in that order, other objects slots A.. in that order. Env e starts
  on pool map e % P.
* A step: an env whose episode ended on the last step is rebuilt from the map
  the traffic picked for it; the step count rises by one; rewards, the last
  action and success are cleared; the agents act one at a time in the
  traffic's order (``perm[i]`` acts at rank i), each seeing the moves before
  it: a move takes the agent one cell on if that cell is on the map and
  empty, noop always succeeds. Then the observations, the coverage,
  visited-staleness and token stats, the rewards (the change of a weighted
  inventory sum) and the episode end at ``max_steps``.
* Stats count exactly, but for the game's, which are float32 counters as
  upstream's stats tracker keeps them.
* An observation is ``num_tokens`` triples (location, feature, value): the
  global tokens at location 0xFE, then for each cell of the vision window in
  Manhattan order the tokens of the object there (its tags ascending, its
  vibe if not 0, its inventory digits, and for an agent its group and id),
  then 0xFF triples.
"""

from __future__ import annotations

import math

import numpy as np

FIXED_FEATURES = (
    "agent:group", "episode_completion_pct", "last_action", "last_reward", "goal", "vibe", "tag",
    "lp:east", "lp:west", "lp:north", "lp:south", "agent_id",
)
GLOBAL_FEATURES = (
    ("episode_completion_pct", "episode_completion_pct"),
    ("last_action", "last_action"),
    ("last_reward", "last_reward"),
)
EMPTY = 0xFF
GLOBAL_LOCATION = 0xFE
MOVES = {"move_north": (-1, 0), "move_south": (1, 0), "move_west": (0, -1), "move_east": (0, 1)}
CELL_STATS = ("cell.visited", "cell.unique_visited", "cell.max_distance_from_spawn")
TOKEN_STATS = ("tokens_written", "tokens_dropped", "tokens_free_space")


def inventory_tokens(max_value: int, base: int) -> int:
    """Digits of base ``base`` that encode ``max_value`` (65535 upstream)."""
    return max(1, math.ceil(math.log(max_value + 1, base)))


def feature_ids(resources, base: int) -> dict:
    """Feature name -> id: the fixed core features, then each resource's
    inventory digits (``inv:<r>``, ``inv:<r>:p1``, ...)."""
    ids = {name: i for i, name in enumerate(FIXED_FEATURES)}
    for r in resources:
        for p in range(inventory_tokens(65535, base)):
            ids[f"inv:{r}" if p == 0 else f"inv:{r}:p{p}"] = len(ids)
    return ids


def in_vision(dr: int, dc: int, height: int, width: int) -> bool:
    """The vision mask: the disc dr^2 + dc^2 <= r^2 of a square window, its
    four cardinal tips widened by one cell for r >= 2; an ellipse otherwise."""
    rr, cr = height // 2, width // 2
    if rr == 0 and cr == 0:
        return dr == 0 and dc == 0
    if rr == 0:
        return dr == 0 and abs(dc) <= cr
    if cr == 0:
        return dc == 0 and abs(dr) <= rr
    if rr == cr:
        d2 = dr * dr + dc * dc
        return d2 <= rr * rr or (rr >= 2 and d2 == rr * rr + 1 and (abs(dr) == rr or abs(dc) == rr))
    return dr * dr * cr * cr + dc * dc * rr * rr <= rr * rr * cr * cr


def window_offsets(height: int, width: int) -> list[tuple[int, int]]:
    """The cells an agent sees, in the order its tokens come: by Manhattan
    distance d, rows -d..d (row 0 alone at d = 0), the -dc column before +dc,
    those inside the vision mask."""
    rmax, cmax = height // 2, width // 2
    out = [(0, 0)]
    for d in range(1, rmax + cmax + 1):
        for dr in range(-d, d + 1):
            dc = d - abs(dr)
            for c in ((0,) if dc == 0 else (-dc, dc)):
                if abs(dr) <= rmax and abs(c) <= cmax and in_vision(dr, c, height, width):
                    out.append((dr, c))
    return out


class Game:
    """What the configuration file fixes: ids, tables and the window."""

    def __init__(self, spec: dict, max_steps: int):
        obs = spec["obs"]
        self.A = spec["num_agents"]
        self.T = obs["num_tokens"]
        self.base = obs["token_value_base"]
        self.oh, self.ow = obs["height"], obs["width"]
        self.max_steps = max_steps
        self.resources = list(spec["resources"])
        self.R = len(self.resources)
        self.n_inv = inventory_tokens(65535, self.base)
        self.fid = feature_ids(self.resources, self.base)
        self.globals = [name for name, flag in GLOBAL_FEATURES if obs["global_obs"][flag]]
        types = {"agent": spec["agent"], **spec["objects"]}
        tags = sorted({f"type:{t}" for t in types} | {tag for cfg in types.values() for tag in cfg.get("tags", ())})
        self.tag_id = {tag: i for i, tag in enumerate(tags)}
        self.type_names = list(types)
        self.type_tags = [sorted(self.tag_id[t] for t in [f"type:{name}", *cfg.get("tags", ())])
                          for name, cfg in types.items()]
        self.type_vibe = [cfg.get("vibe", 0) for cfg in types.values()]
        self.type_inv = np.array([[cfg.get("inventory", {}).get(r, 0) for r in self.resources]
                                  for cfg in types.values()], dtype=np.int64).reshape(len(types), self.R)
        self.group = spec["agent"]["group"]
        self.reward_w = np.array([spec["agent"]["rewards"].get(r, 0.0) for r in self.resources])
        self.actions = list(spec["actions"])
        self.move_d = np.array([MOVES.get(a, (0, 0)) for a in self.actions], dtype=np.int64)
        self.is_move = np.array([a in MOVES for a in self.actions])
        families = list(dict.fromkeys(a.split("_")[0] for a in self.actions))
        self.stat_names = ([f"action.{f}.success" for f in families] + [f"action.{f}.failed" for f in families]
                           + ["action.failed", "action.invalid_index", "status.max_steps_without_motion"])
        fam = [families.index(a.split("_")[0]) for a in self.actions]
        self.succ_stat = np.array(fam)
        self.fail_stat = np.array(fam) + len(families)
        self.stat_failed = 2 * len(families)
        self.stat_swm = 2 * len(families) + 2
        off = window_offsets(self.oh, self.ow)
        self.off_r = np.array([o[0] for o in off])
        self.off_c = np.array([o[1] for o in off])
        self.hr, self.wr = self.oh // 2, self.ow // 2
        self.loc = ((self.off_r + self.hr) << 4) | (self.off_c + self.wr)

    def object_tokens(self, type_id: int, vibe: int, inv, slot: int) -> list[tuple[int, int]]:
        """(feature, value) of one object's tokens, in their order."""
        toks = [(self.fid["tag"], t) for t in self.type_tags[type_id]]
        if vibe != 0:
            toks.append((self.fid["vibe"], vibe))
        for r, name in enumerate(self.resources):
            for p in range(self.n_inv):
                if inv[r] >= self.base ** p:
                    toks.append((self.fid[f"inv:{name}" if p == 0 else f"inv:{name}:p{p}"],
                                 (int(inv[r]) // self.base ** p) % self.base))
        if slot < self.A:
            toks += [(self.fid["agent:group"], self.group), (self.fid["agent_id"], slot)]
        return toks


def cells(grid) -> tuple:
    """(cell names row-major, agent cells, other object cells) of a map."""
    flat = np.asarray(grid).astype(str).reshape(-1)
    occupied = (flat != "empty") & (flat != "")
    is_agent = np.char.startswith(flat, "agent")
    return flat, np.flatnonzero(occupied & is_agent), np.flatnonzero(occupied & ~is_agent)


class PoolMap:
    """One pool map's start state, from its grid of cell names."""

    def __init__(self, game: Game, grid: np.ndarray):
        H, W = np.shape(grid)
        flat, agents, objects = cells(grid)
        if len(agents) != game.A:
            raise ValueError(f"map has {len(agents)} agent cells, expected {game.A}")
        unknown = set(flat[objects]) - set(game.type_names)
        if unknown:
            raise ValueError(f"map cells of no configured type: {sorted(unknown)}")
        self.N = game.A + len(objects)
        self.slot_grid = np.full(H * W, -1, dtype=np.int64)
        self.slot_grid[agents] = np.arange(game.A)
        self.slot_grid[objects] = game.A + np.arange(len(objects))
        self.slot_grid = self.slot_grid.reshape(H, W)
        self.type = np.array([0] * game.A + [game.type_names.index(n) for n in flat[objects]], dtype=np.int64)
        self.spawn_r, self.spawn_c = agents // W, agents % W
        self.vibe = np.array([game.type_vibe[t] for t in self.type], dtype=np.int64)
        self.inv = game.type_inv[self.type]
        self.n_tokens = np.array([len(game.object_tokens(t, v, inv, s))
                                  for s, (t, v, inv) in enumerate(zip(self.type, self.vibe, self.inv))])


class Arena:
    """S envs of the arena game, stepped together but each on its own.

    ``grids``: the pool's map grids; ``initial_maps``: int[S], the pool map
    each env starts on."""

    def __init__(self, spec: dict, grids, initial_maps, max_steps: int):
        self.g = Game(spec, max_steps)
        self.grids = grids
        self.maps: dict[int, PoolMap] = {}
        S, A = len(initial_maps), self.g.A
        H, W = np.asarray(grids[0]).shape
        self.S, self.H, self.W = S, H, W
        self.N = A + max(len(cells(g)[2]) for g in grids)
        i64 = np.int64
        self.grid = np.full((S, H, W), -1, dtype=i64)
        self.map_idx = np.zeros(S, dtype=i64)
        self.pos_r, self.pos_c = np.zeros((S, A), i64), np.zeros((S, A), i64)
        self.spawn_r, self.spawn_c = np.zeros((S, A), i64), np.zeros((S, A), i64)
        self.swm = np.zeros((S, A), i64)
        self.last_action = np.zeros((S, A), i64)
        self.success = np.zeros((S, A), bool)
        self.stats = np.zeros((S, A, len(self.g.stat_names)), i64)
        self.cell = np.zeros((S, A, len(CELL_STATS)), i64)
        self.seen = np.zeros((S, A, H * W), bool)
        self.obj_visited = np.zeros((S, self.N), i64)
        self.obj_type = np.zeros((S, self.N), i64)
        self.obj_vibe = np.zeros((S, self.N), i64)
        self.obj_inv = np.zeros((S, self.N, self.g.R), i64)
        self.obj_tokens = np.zeros((S, self.N), i64)
        # Game stats are float32 counters, as upstream's stats tracker keeps
        # them: past 2**24 a count rounds to even.
        self.tokens = np.zeros((S, len(TOKEN_STATS)), np.float32)
        self.step_count = np.zeros(S, i64)
        self.rewards = np.zeros((S, A))
        self.reward_prev = np.zeros((S, A))
        self.episode_rewards = np.zeros((S, A))
        self.terminals = np.zeros((S, A), bool)
        self.attempted = np.zeros((S, A), i64)
        for s, m in enumerate(initial_maps):
            self._load(s, int(m))

    def _map(self, m: int) -> PoolMap:
        if m not in self.maps:
            self.maps[m] = PoolMap(self.g, self.grids[m])
        return self.maps[m]

    def _load(self, s: int, m: int) -> None:
        """Env s rebuilt from pool map m, with the token stats of the
        observation its construction makes."""
        pm = self._map(m)
        n = pm.N
        self.map_idx[s] = m
        self.grid[s] = pm.slot_grid
        self.pos_r[s], self.pos_c[s] = pm.spawn_r, pm.spawn_c
        self.spawn_r[s], self.spawn_c[s] = pm.spawn_r, pm.spawn_c
        self.swm[s] = 0
        self.last_action[s] = 0
        self.success[s] = False
        self.stats[s] = 0
        self.cell[s] = 0
        self.cell[s, :, 1] = 1  # the spawn cell counts as visited
        self.seen[s] = False
        self.seen[s, np.arange(self.g.A), pm.spawn_r * self.W + pm.spawn_c] = True
        self.obj_visited[s] = 0
        self.obj_type[s] = 0
        self.obj_type[s, :n] = pm.type
        self.obj_vibe[s] = 0
        self.obj_vibe[s, :n] = pm.vibe
        self.obj_inv[s] = 0
        self.obj_inv[s, :n] = pm.inv
        self.obj_tokens[s] = 0
        self.obj_tokens[s, :n] = pm.n_tokens
        self.step_count[s] = 0
        self.rewards[s] = 0.0
        self.reward_prev[s] = 0.0
        self.episode_rewards[s] = 0.0
        self.terminals[s] = False
        self.tokens[s] = 0
        self._count_tokens(np.array([s]))

    def _window(self, img: np.ndarray, envs: np.ndarray, fill) -> np.ndarray:
        """img[i, r + dr, c + dc] over the window of every agent of env envs[i]
        (img holds those envs' rows), [len(envs), A, K]; cells off the map
        read ``fill``."""
        g = self.g
        n, H, W = img.shape
        rows = self.pos_r[envs][:, :, None] + g.off_r
        cols = self.pos_c[envs][:, :, None] + g.off_c
        inside = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
        cells = rows.clip(0, H - 1) * W + cols.clip(0, W - 1)
        return np.where(inside, img.reshape(n, -1)[np.arange(n)[:, None, None], cells], fill)

    def _count_tokens(self, envs: np.ndarray, slots: np.ndarray = None) -> None:
        """Tokens attempted by each agent's observation, and the token stats;
        ``slots``: the envs' windows of object slots, where already read."""
        if slots is None:
            slots = self._window(self.grid[envs], envs, -1)
        per_object = self.obj_tokens[envs][np.arange(len(envs))[:, None, None], slots.clip(0)]
        attempted = len(self.g.globals) + np.where(slots >= 0, per_object, 0).sum(axis=2)
        self.attempted[envs] = attempted
        written = np.minimum(attempted, self.g.T)
        counts = np.stack([written.sum(1), (attempted - written).sum(1), (self.g.T - written).sum(1)], 1)
        self.tokens[envs] = self.tokens[envs] + counts.astype(np.float32)

    def step(self, actions: np.ndarray, perm: np.ndarray, reset_maps: np.ndarray,
             vibe_actions: np.ndarray = None) -> None:
        """One step of every env: actions int[S, A], perm int[S, A] (the agent
        acting at each rank), reset_maps int[S] (the map of an env that
        resets); vibe_actions int[S, A] have to be 0 (noop): the arena game
        changes no vibe."""
        g, S, A, W = self.g, self.S, self.g.A, self.W
        if vibe_actions is not None and np.any(vibe_actions != 0):
            raise ValueError("the arena game takes no vibe actions")
        for s in np.flatnonzero(self.terminals.any(axis=1)):
            self._load(s, int(reset_maps[s]))
        self.step_count += 1
        actions = np.asarray(actions, dtype=np.int64)
        if ((actions < 0) | (actions >= len(g.actions))).any():
            raise ValueError("action index out of range")
        order = np.asarray(perm, dtype=np.int64)
        ranked = np.take_along_axis(actions, order, 1)  # the action of the agent at each rank
        dr, dc, is_move = g.move_d[ranked, 0], g.move_d[ranked, 1], g.is_move[ranked]
        envs = np.arange(S)
        flat = self.grid.reshape(S, -1)
        moved = np.zeros((S, A), bool)
        for i in range(A):  # one rank at a time: a move sees the moves before it
            a = order[:, i]
            r, c = self.pos_r[envs, a], self.pos_c[envs, a]
            tr, tc = r + dr[:, i], c + dc[:, i]
            ok = is_move[:, i] & (tr >= 0) & (tr < self.H) & (tc >= 0) & (tc < W)
            ok[ok] = flat[envs[ok], tr[ok] * W + tc[ok]] < 0
            m, am = envs[ok], a[ok]
            flat[m, r[ok] * W + c[ok]] = -1
            flat[m, tr[ok] * W + tc[ok]] = am
            self.pos_r[m, am], self.pos_c[m, am] = tr[ok], tc[ok]
            moved[m, am] = True
        # Each agent acted once; an agent that did not move stood still.
        ok = ~g.is_move[actions] | moved
        si, ai = np.indices((S, A))
        self.stats[si, ai, np.where(ok, g.succ_stat[actions], g.fail_stat[actions])] += 1
        self.stats[:, :, g.stat_failed] += ~ok
        swm = np.where(moved, 0, self.swm + 1)
        top = self.stats[:, :, g.stat_swm]
        self.stats[:, :, g.stat_swm] = np.where(~moved & (swm > top), swm, top)
        self.swm = swm
        self.last_action = np.where(ok, actions, 0)
        self.success = ok
        slots = self._window(self.grid, envs, -1)  # [S, A, K] object slots in each agent's window
        self._count_tokens(envs, slots)
        self._coverage()
        self._visited(slots)
        value = (self.obj_inv[:, :A] * g.reward_w).sum(axis=2)
        self.rewards = value - self.reward_prev
        self.reward_prev = value
        self.episode_rewards += self.rewards
        self.terminals |= (self.step_count >= g.max_steps)[:, None]

    def _coverage(self) -> None:
        A = self.g.A
        cell = self.pos_r * self.W + self.pos_c
        idx = (np.arange(self.S)[:, None], np.arange(A)[None, :], cell)
        self.cell[:, :, 1] += ~self.seen[idx]
        self.seen[idx] = True
        dist = np.abs(self.pos_r - self.spawn_r) + np.abs(self.pos_c - self.spawn_c)
        self.cell[:, :, 2] = np.maximum(self.cell[:, :, 2], dist)

    def _visited(self, slots: np.ndarray) -> None:
        """Each object in some agent's vision is claimed by the agent of the
        lowest slot that sees it, which adds the steps since the object was
        last claimed."""
        S, A = self.S, self.g.A
        seen = slots >= 0
        si = np.broadcast_to(np.arange(S)[:, None, None], slots.shape)[seen]
        ai = np.broadcast_to(np.arange(A)[None, :, None], slots.shape)[seen]
        first = np.full((S, self.N), A)
        np.minimum.at(first, (si, slots[seen]), ai)
        claim = first < A
        cs, co = np.nonzero(claim)
        np.add.at(self.cell[:, :, 0], (cs, first[cs, co]), self.step_count[cs] - self.obj_visited[cs, co])
        self.obj_visited[cs, co] = self.step_count[cs]

    def observations(self) -> np.ndarray:
        """uint8[S, A, T, 3]: each agent's observation after the last step."""
        g = self.g
        out = np.full((self.S, g.A, g.T, 3), EMPTY, dtype=np.uint8)
        for s in range(self.S):
            step = int(self.step_count[s])
            pct = 255 if step >= g.max_steps else (256 * step) // g.max_steps
            for a in range(g.A):
                values = {"episode_completion_pct": pct, "last_action": int(self.last_action[s, a]),
                          "last_reward": int(np.round(np.float32(self.rewards[s, a]) * np.float32(100.0)))}
                toks = [(GLOBAL_LOCATION, g.fid[name], values[name] & 0xFF) for name in g.globals]
                r, c = int(self.pos_r[s, a]), int(self.pos_c[s, a])
                for k in range(len(g.off_r)):
                    rr, cc = r + int(g.off_r[k]), c + int(g.off_c[k])
                    if not (0 <= rr < self.H and 0 <= cc < self.W):
                        continue
                    slot = int(self.grid[s, rr, cc])
                    if slot >= 0:
                        toks += [(int(g.loc[k]), f, v & 0xFF) for f, v in
                                 g.object_tokens(int(self.obj_type[s, slot]), int(self.obj_vibe[s, slot]),
                                                 self.obj_inv[s, slot], slot)]
                toks = toks[: g.T]
                if toks:
                    out[s, a, : len(toks)] = np.array(toks, dtype=np.uint8)
        return out

    def outputs(self) -> dict:
        """The last step's outputs for the S envs."""
        return {
            "observations": self.observations(),
            "tokens_attempted": self.attempted.copy(),
            "rewards": self.rewards.copy(),
            "terminals": self.terminals.copy(),
            "truncations": np.zeros_like(self.terminals),
        }

    def results(self) -> dict:
        """The named results a run compares, for the S envs."""
        res = {
            **self.outputs(),
            "positions": np.stack([self.pos_r, self.pos_c], axis=-1),
            "grid": self.grid.copy(),
            "episode_rewards": self.episode_rewards.copy(),
            "step_count": self.step_count.copy(),
            "map_idx": self.map_idx.copy(),
            "action_success": self.success.copy(),
        }
        for k, name in enumerate(self.g.stat_names):
            res[f"agent_stat:{name}"] = self.stats[:, :, k].copy()
        for k, name in enumerate(CELL_STATS):
            res[f"agent_stat:{name}"] = self.cell[:, :, k].copy()
        for k, name in enumerate(TOKEN_STATS):
            res[f"game_stat:{name}"] = self.tokens[:, k].copy()
        return res
