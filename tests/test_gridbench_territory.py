"""The benchmark's territory cell: its plain reference held to hand-built
cases of the rules (never to the program), then the cell run on the CPU at a
small size against it, and the control that breaks the agent order."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gridbench import run
from gridbench.control import identity_order
from gridbench.reference.territory import Arena, isqrt_table

SPEC = json.loads((Path(__file__).resolve().parents[1] / "gridbench" / "configs" / "territory.json").read_text())
NOOP, NORTH, SOUTH, WEST, EAST = range(5)
HEART, ARMOR = SPEC["resources"].index("heart"), SPEC["resources"].index("armor")
NAMES = {"#": "wall", ".": "empty", "@": "agent.agent", "C": "junction_cogs", "K": "junction_clips",
         "B": "junction_both"}
SMALL = {"envs": 8, "pool": 3, "check_envs": 8}


@pytest.fixture(autouse=True)
def one_thread():
    """Every test here on one intra-op thread: its tensors are small, and beside other test processes a
    pool of threads per process can stall a step for seconds (a run's window needs two steps for its
    p95)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def grid(rows):
    return np.array([[NAMES[ch] for ch in row] for row in rows])


def game(rows, agents=1, spec=None, max_steps=100):
    spec = {**(spec or SPEC), "num_agents": agents}
    return Arena(spec, [grid(rows)], np.array([0]), max_steps)


def step(env, actions):
    A = len(actions)
    env.step(np.array([actions]), np.array([list(range(A))]), np.array([0]))


def tag(env, name):
    return env.g.tag_names.index(name)


def owner(env):
    return env.owner_image(np.array([0]))[0].numpy()


def open_room(width=11, height=11, marks=()):
    """A walled room with ``marks`` ((r, c, ch)) placed in it."""
    rows = [["#"] * width] + [["#"] + ["."] * (width - 2) + ["#"] for _ in range(height - 2)] + [["#"] * width]
    for r, c, ch in marks:
        rows[r][c] = ch
    return ["".join(row) for row in rows]


def test_an_ownership_tie_is_neutral():
    env = game(open_room(marks=[(5, 3, "C"), (5, 7, "K"), (1, 1, "@")]))
    own = owner(env)
    assert own[5, 5] == -1  # as near to both
    assert own[5, 4] == tag(env, "team:cogs") and own[5, 6] == tag(env, "team:clips")
    assert own[3, 5] == -1 and own[8, 5] == -1  # still equidistant


def test_the_decay_edge_at_d2_16():
    assert isqrt_table(16)[16] == 4096  # 256 * 4096 = 1024 * 1024: no influence left
    env = game(open_room(width=13, height=13, marks=[(6, 6, "C"), (1, 1, "@")]))
    own = owner(env)
    cogs = tag(env, "team:cogs")
    assert own[6, 10] == -1 and own[10, 6] == -1  # d2 = 16
    assert own[6, 9] == cogs and own[9, 8] == cogs  # d2 = 9 and 13
    assert own[9, 9] == -1  # d2 = 18


def test_a_sources_first_prefix_tag_decides():
    spec = copy.deepcopy(SPEC)
    spec["objects"]["junction_both"] = {**spec["objects"]["junction_cogs"], "tags": ["team:cogs", "team:clips"]}
    env = game(open_room(marks=[(5, 5, "B"), (1, 1, "@")]), spec=spec)
    # team:clips sorts before team:cogs: the lower tag id decides.
    assert owner(env)[5, 6] == tag(env, "team:clips")


def test_enter_and_exit_change_armor():
    # The junction at (5, 2); the agent at d2 = 16 (neutral), then 9 (owned, outside the AOE's reach).
    env = game(open_room(width=11, height=11, marks=[(5, 2, "C"), (5, 6, "@")]))
    step(env, [NOOP])
    assert env.obj_inv[0, 0, ARMOR] == 0
    step(env, [WEST])
    assert tuple(env.results()["positions"][0, 0]) == (5, 5)
    assert env.obj_inv[0, 0, ARMOR] == 1
    step(env, [EAST])
    assert env.obj_inv[0, 0, ARMOR] == 0


def test_presence_gives_hearts_in_friendly_territory_only():
    # Agent 0 at d2 = 9 from a cogs junction, agent 1 at d2 = 9 from a clips junction.
    env = game(open_room(width=15, height=7, marks=[(3, 2, "C"), (3, 5, "@"), (3, 12, "K"), (3, 9, "@")]),
               agents=2)
    for _ in range(3):
        step(env, [NOOP, NOOP])
    assert env.obj_inv[0, :2, HEART].tolist() == [3, 0]
    assert env.obj_inv[0, :2, ARMOR].tolist() == [1, 1]  # both entered owned territory
    assert env.results()["rewards"][0].tolist() == [1.0, 0.0]


def test_the_aoe_reaches_its_radius_and_its_team():
    # Agent 0 at d2 = 4 from a cogs junction (AOE and territory), agent 1 at d2 = 5 (territory only),
    # agent 2 at d2 = 4 from a clips junction (neither: other team).
    env = game(open_room(width=17, height=9, marks=[(4, 3, "C"), (4, 5, "@"), (2, 4, "@"), (4, 13, "K"),
                                                    (4, 11, "@")]), agents=3)
    step(env, [NOOP] * 3)
    slot = {(int(r), int(c)): a for a, (r, c) in enumerate(env.results()["positions"][0])}
    a0, a1, a2 = slot[(4, 5)], slot[(2, 4)], slot[(4, 11)]
    assert env.obj_inv[0, a0, HEART] == 2 and env.obj_inv[0, a0, ARMOR] == 2
    assert env.obj_inv[0, a1, HEART] == 1 and env.obj_inv[0, a1, ARMOR] == 1
    assert env.obj_inv[0, a2, HEART] == 0 and env.obj_inv[0, a2, ARMOR] == 1


def _clamp_spec():
    """Junctions with presence deltas of -1 armor and no territory, so only the AOE moves armor."""
    spec = copy.deepcopy(SPEC)
    for name in ("junction_cogs", "junction_clips"):
        spec["objects"][name]["territory_controls"] = []
        spec["objects"][name]["aoes"]["charge"]["presence_deltas"] = {"armor": -1}
    return spec


@pytest.mark.parametrize("start, move, armor", [(4, WEST, 1), (3, EAST, 0)])
def test_presence_deltas_apply_per_source_at_the_clamp(start, move, armor):
    # Junctions at columns 1 and 6; one move leaves one's reach and enters the other's.
    row = list("#C....C#")
    row[start] = "@"
    env = game(["########", "".join(row), "########"], spec=_clamp_spec())
    step(env, [NOOP])  # entering: 0 - 1 clamps at 0
    assert env.obj_inv[0, 0, ARMOR] == 0 and env.clamped_presence == 1
    step(env, [move])
    # Slot order: the left junction acts first. Entering it first clamps (0, then +1 for leaving the right
    # one); leaving it first gives +1, then -1 for entering the right one. A net count would give 0 in both.
    assert env.obj_inv[0, 0, ARMOR] == armor
    assert env.clamped_presence == 1 + (armor == 1)


def test_the_mask_token_leads_owned_cells():
    env = game(open_room(width=13, height=13, marks=[(3, 3, "C"), (9, 9, "K"), (6, 6, "@")]))
    step(env, [NOOP])
    obs = env.observations().numpy()[0, 0]
    mask = obs[obs[:, 1] == env.g.mask_feature]
    assert set(mask[:, 2].tolist()) == {1, 2}  # 0 (neutral) is never a token
    own = owner(env)
    cogs, clips = tag(env, "team:cogs"), tag(env, "team:clips")
    for loc, _, value in mask:
        r, c = loc >> 4, loc & 0xF  # the agent sits at (6, 6), the window's centre
        assert own[r, c] == (cogs if value == 1 else clips)
    # Each mask token comes first among its cell's tokens.
    locs = obs[:, 0].tolist()
    for i in np.flatnonzero(obs[:, 1] == env.g.mask_feature):
        assert i == 0 or locs[i - 1] != locs[i]
    assert env.g.mask_feature == 52  # after 12 core, 20 inventory and 20 protocol features


def _cpu_run(seed, **hooks):
    return run.run_cell("territory.random_long", seed, 3.0, False, device="cpu", spec_overrides=SMALL, **hooks)


def test_the_cell_runs_correct_on_the_cpu():
    res = _cpu_run(2**31 + 23)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert res["run"]["objects"] == 638 and res["run"]["steps_checked"] > 8


def test_the_control_is_not_correct():
    res = _cpu_run(2**31 + 23, feed=identity_order)
    assert not res["correct"] and res["failed"] > 0


def test_no_presence_delta_meets_a_clamp_in_the_cell():
    # Armor counts the reaches and the territory an agent is in, so neither clamp binds: the per-source order
    # of presence deltas and a net count per agent give the same bytes in this configuration.
    from gridbench import traffic

    spec = {**SPEC, **SMALL}
    params = traffic.load("random_long")
    rows = np.arange(spec["envs"])
    inputs = traffic.Traffic(params, 7, spec["envs"], spec["num_agents"], spec["actions"], spec["pool"],
                             "cpu").replay(300, torch.from_numpy(rows))
    env = Arena(spec, run.reference_pool(spec), rows % spec["pool"], spec["max_steps"])
    for i in range(300):
        env.step(**{k: v[i] for k, v in inputs.items()})
    assert env.clamped_presence == 0
    assert env.obj_inv[:, :24, ARMOR].max() <= 3 and env.obj_inv[:, :24, HEART].max() > 0


def port_game(rows, spec):
    """The program on one env of the hand-built map ``rows``, stepped with the agents in slot order;
    returns step(actions) -> the agents' inventories after it (int64[A, R])."""
    from gridbench.configs.territory import port_config
    from mettagrid_tpu_torch.engine import build_env_init, compile_program, make_reset, make_step
    from mettagrid_tpu_torch.maps.map_builder import GameMap

    program = compile_program(port_config({**spec, "num_agents": 1}, 100))
    init = build_env_init(program, [GameMap(grid(rows))])
    step_fn = make_step(program, init, auto_reset=True, external_perm=True, device="cpu")
    box = list(make_reset(program, init, 1, device="cpu")(0))

    def one(actions):
        acts = torch.tensor([actions], dtype=torch.int32)
        perm = torch.arange(len(actions), dtype=torch.int32)[None]
        maps = torch.zeros(1, dtype=torch.int32)
        box[:] = step_fn(box[0], acts, torch.zeros_like(acts), perm, box[1].observations, maps)
        return box[0].obj_inv[0, :len(actions)].long()

    return one


@pytest.mark.parametrize("start, move, armor", [(4, WEST, 1), (3, EAST, 0)])
def test_the_port_applies_presence_deltas_per_source_at_the_clamp(start, move, armor):
    row = list("#C....C#")
    row[start] = "@"
    rows = ["########", "".join(row), "########"]
    env, port = game(rows, spec=_clamp_spec()), port_game(rows, _clamp_spec())
    for action in (NOOP, move):
        step(env, [action])
        assert port([action])[0].tolist() == env.obj_inv[0, 0].tolist()
    assert env.obj_inv[0, 0, ARMOR] == armor


def test_the_port_applies_per_tick_deltas_once_over_every_spec():
    # The agent stands in both junctions' reach; -1 heart from one and +1 from the other net to 0 before the
    # clamp at 0. Spec by spec they would give 1 (0 - 1 clamps at 0, then + 1).
    spec = _clamp_spec()
    for name, delta in (("junction_cogs", -1), ("junction_clips", 1)):
        charge = spec["objects"][name]["aoes"]["charge"]
        charge.pop("shared_tag_prefix")
        charge["deltas"], charge["presence_deltas"] = {"heart": delta}, {}
    rows = ["#######", "#C.@.K#", "#######"]
    env, port = game(rows, spec=spec), port_game(rows, spec)
    for _ in range(3):
        step(env, [NOOP])
        assert port([NOOP])[0].tolist() == env.obj_inv[0, 0].tolist()
    assert env.obj_inv[0, 0, HEART] == 0


def test_where_types_may_change_the_aoe_phase_reads_its_sources_back(monkeypatch):
    # Where a phase may write an object's type (a spawn), the pool does not bound the sources with presence
    # deltas: their number is read back, and the deltas are the same.
    from gridbench.configs.territory import port_config
    from mettagrid_tpu_torch.engine import aoe, build_env_init, compile_program, make_reset
    from mettagrid_tpu_torch.engine.aoe import make_aoe_phase
    from mettagrid_tpu_torch.maps.map_builder import GameMap
    from mettagrid_tpu_torch.profiling import trace

    spec = _clamp_spec()
    spec["objects"]["junction_cogs"]["aoes"]["charge"]["presence_deltas"] = {"armor": 2}
    program = compile_program(port_config({**spec, "num_agents": 1}, 100))
    init = build_env_init(program, [GameMap(grid(["########", "#C.@..C#", "########"]))])
    state, _ = make_reset(program, init, 1, device="cpu")(0)
    bounded = make_aoe_phase(program, init)
    written = aoe.maybe_written_pool_fields(program)
    assert "obj_type" not in written
    monkeypatch.setattr(aoe, "maybe_written_pool_fields", lambda p: written | {"obj_type"})
    read = trace.program_step(make_aoe_phase(program, init))
    read(state)  # the first call is set-up
    key = "host_syncs.aoe.presence_sources"
    before = trace.snapshot().get(key, {}).get("count", 0)
    got, want = read(state), bounded(state)
    assert trace.snapshot().get(key, {}).get("count", 0) - before == 1
    assert want.obj_inv[0, 0, ARMOR] == 2  # entering the left junction's reach
    assert torch.equal(got.obj_inv, want.obj_inv) and torch.equal(got.aoe_inside, want.aoe_inside)


def test_the_mask_bytes_count_the_sources_once_and_a_static_background_once_per_map():
    from gridbench.metrics.aoe_obs_bytes import SOURCE_BYTES, aoe_obs_bytes, sources, tags
    from gridbench.metrics.obs_bytes import object_bytes, obs_bytes

    R = len(SPEC["resources"])
    assert SPEC["background"] == "static" and tags(SPEC) == 6 and sources(SPEC) == 4
    shapes = dict(envs=8, agents=24, objects=638, pool=3, resources=R, tokens=1000)
    static = aoe_obs_bytes(SPEC, static_background=True, **shapes)
    assert static == obs_bytes(tags=6, static_background=True, **shapes) + 8 * 4 * SOURCE_BYTES
    assert aoe_obs_bytes(SPEC, static_background=False, **shapes) - static == (8 - 3) * 614 * object_bytes(R, 6)
