"""The plain reference held to hand-built cases (never to the program)."""

import json
from pathlib import Path

import numpy as np
import pytest

from gridbench.reference.arena import EMPTY, GLOBAL_LOCATION, Arena, window_offsets
from gridbench.reference.maps.mapgen_random import draw

SPEC = json.loads((Path(__file__).resolve().parents[1] / "configs" / "arena.json").read_text())
NOOP, NORTH, SOUTH, WEST, EAST = range(5)
# Feature ids of the arena configuration: the fixed core features.
GROUP, EPCT, LAST_ACTION, LAST_REWARD, TAG, AGENT_ID = 0, 1, 2, 3, 6, 11
AGENT_TAG, WALL_TAG = 0, 1  # "type:agent" < "type:wall"


def grid(rows):
    names = {"#": "wall", ".": "empty", "@": "agent.agent"}
    return np.array([[names[ch] for ch in row] for row in rows])


def arena(maps, agents, max_steps=100, initial=(0,)):
    spec = {**SPEC, "num_agents": agents}
    return Arena(spec, [grid(m) for m in maps], np.array(initial), max_steps)


def step(env, actions, perm, reset_map=0):
    env.step(np.array([actions]), np.array([perm]), np.array([reset_map]))


CORRIDOR = ["#####", "#@.@#", "#####"]


def test_contention_first_in_order_wins():
    for perm, winner, loser in (([0, 1], 0, 1), ([1, 0], 1, 0)):
        env = arena([CORRIDOR], 2)
        step(env, [EAST, WEST], perm)
        res = env.results()
        assert tuple(res["positions"][0, winner]) == (1, 2)
        assert tuple(res["positions"][0, loser]) == ((1, 1) if loser == 0 else (1, 3))
        assert res["action_success"][0, winner] and not res["action_success"][0, loser]
        assert res["agent_stat:action.move.success"][0, winner] == 1
        assert res["agent_stat:action.move.failed"][0, loser] == 1
        assert res["agent_stat:action.failed"][0].tolist() == [int(loser == 0), int(loser == 1)]
        assert res["grid"][0, 1, 2] == winner


def test_move_into_wall_fails_and_counts_standing_still():
    env = arena([["###", "#@#", "###"]], 1)
    for _ in range(3):
        step(env, [NORTH], [0])
    res = env.results()
    assert tuple(res["positions"][0, 0]) == (1, 1)
    assert res["agent_stat:action.move.failed"][0, 0] == 3
    assert res["agent_stat:action.failed"][0, 0] == 3
    assert res["agent_stat:status.max_steps_without_motion"][0, 0] == 3
    assert res["action_success"][0, 0] == 0
    step(env, [NOOP], [0])
    res = env.results()
    assert res["agent_stat:action.noop.success"][0, 0] == 1
    assert res["agent_stat:status.max_steps_without_motion"][0, 0] == 4


def test_episode_end_rebuilds_from_the_picked_map():
    maps = [["#####", "#@..#", "#####"], ["#####", "#..@#", "#####"]]
    env = arena(maps, 1, max_steps=2, initial=(0,))
    step(env, [EAST], [0], reset_map=1)
    step(env, [EAST], [0], reset_map=1)
    res = env.results()
    assert res["terminals"][0, 0] and res["step_count"][0] == 2
    assert tuple(res["positions"][0, 0]) == (1, 3) and res["map_idx"][0] == 0
    step(env, [WEST], [0], reset_map=1)  # ended last step: rebuilt on map 1, then acts
    res = env.results()
    assert res["map_idx"][0] == 1 and res["step_count"][0] == 1 and not res["terminals"][0, 0]
    assert tuple(res["positions"][0, 0]) == (1, 2)
    assert res["agent_stat:action.move.success"][0, 0] == 1
    assert res["agent_stat:cell.unique_visited"][0, 0] == 2
    assert res["agent_stat:cell.max_distance_from_spawn"][0, 0] == 1
    # Token stats: the construction's observation plus this step's.
    T = SPEC["obs"]["num_tokens"]
    written = res["game_stat:tokens_written"][0]
    attempted = res["tokens_attempted"][0, 0]
    assert written == attempted + 3 + 3 + 12  # 3 globals, its own 3 tokens, 12 walls in view at spawn
    assert res["game_stat:tokens_free_space"][0] == 2 * T - written


def test_token_bytes_of_a_known_window():
    env = arena([["#####", "#...#", "#.@.#", "#.#.#", "#####"]], 1, max_steps=10)
    step(env, [NOOP], [0])
    obs = env.results()["observations"][0, 0]
    loc = lambda dr, dc: ((dr + 6) << 4) | (dc + 6)  # noqa: E731
    head = [
        (GLOBAL_LOCATION, EPCT, 256 * 1 // 10), (GLOBAL_LOCATION, LAST_ACTION, NOOP), (GLOBAL_LOCATION, LAST_REWARD, 0),
        (loc(0, 0), TAG, AGENT_TAG), (loc(0, 0), GROUP, 0), (loc(0, 0), AGENT_ID, 0),
        (loc(1, 0), TAG, WALL_TAG),  # Manhattan 1: north, west, east are empty; south is the wall
        (loc(-2, 0), TAG, WALL_TAG),  # Manhattan 2, rows -2..2
        (loc(0, -2), TAG, WALL_TAG), (loc(0, 2), TAG, WALL_TAG), (loc(2, 0), TAG, WALL_TAG),
    ]
    assert [tuple(t) for t in obs[: len(head)]] == head
    n_walls = 17
    n = 3 + 3 + n_walls
    assert (obs[:n, 1] == TAG).sum() == 1 + n_walls
    assert (obs[n:] == EMPTY).all()


def test_visited_staleness_goes_to_the_lowest_slot():
    env = arena([["#####", "#@.@#", "#####"]], 2)
    step(env, [NOOP, NOOP], [1, 0])
    step(env, [NOOP, NOOP], [0, 1])
    res = env.results()
    # Every object is in both agents' view; slot 0 claims all 14 (12 walls,
    # two agents) on each step, each 1 step stale.
    assert res["agent_stat:cell.visited"][0].tolist() == [28, 0]


def test_window_order():
    off = window_offsets(13, 13)
    assert len(off) == 121
    assert off[:10] == [(0, 0), (-1, 0), (0, -1), (0, 1), (1, 0), (-2, 0), (-1, -1), (-1, 1), (0, -2), (0, 2)]


def test_game_token_stats_are_float32_counters():
    env = arena([["#####", "#@.##", "#####"]], 1)
    env.tokens[0, 0] = np.float32(2**24)
    step(env, [NOOP], [0])
    res = env.results()
    assert res["tokens_attempted"][0, 0] == 3 + 3 + 13  # odd: 3 globals, its own 3 tokens, 13 walls
    # 2**24 + 19 lies halfway between two float32 values and rounds to the even one.
    assert res["game_stat:tokens_written"][0] == 2**24 + 20


def test_mapgen_random_map_is_what_the_file_states():
    m = SPEC["map"]
    g = draw(m, 7)
    b = m["border_width"]
    assert g.shape == (m["height"] + 2 * b, m["width"] + 2 * b)
    ring = np.ones(g.shape, dtype=bool)
    ring[b:-b, b:-b] = False
    assert (g[ring] == "wall").all()
    room = g[b:-b, b:-b]
    assert (room == "wall").sum() == m["objects"]["wall"] and (room == "agent.agent").sum() == m["agents"]
    assert (draw(m, 7) == g).all() and (draw(m, 8) != g).any()


def test_vibe_actions_are_refused():
    env = arena([CORRIDOR], 2)
    with pytest.raises(ValueError):
        env.step(np.array([[NOOP, NOOP]]), np.array([[0, 1]]), np.array([0]), vibe_actions=np.array([[0, 1]]))
