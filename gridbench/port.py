"""The system under test: mettagrid_tpu_torch built from a configuration file,
and what the harness reads back from it.

The benchmark takes from the program only its entry points (compile_program,
build_env_init, make_reset, make_step), its step's spans and its outputs.
``configs/<name>.py`` turns the configuration file into the program's config
(``port_config(spec, max_steps)``); the pool's maps come from the program's
own map builders, map i seeded with ``pool_seed + i`` (``grids``, which the
check holds to the plain reference's own draw of the pool).
"""

from __future__ import annotations

import importlib.util
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
OUTPUTS = ("observations", "tokens_attempted", "rewards", "terminals", "truncations")


def config_module(name: str):
    """``configs/<name>.py``, loaded by path."""
    path = HERE / "configs" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gridbench_config_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _check_program(program, spec: dict, max_steps: int) -> None:
    """The compiled program has to be what the configuration file states."""
    obs = spec["obs"]
    stated = {
        "num_agents": spec["num_agents"], "action_names": tuple(spec["actions"]),
        "resource_names": tuple(spec["resources"]), "obs_width": obs["width"], "obs_height": obs["height"],
        "num_tokens": obs["num_tokens"], "token_value_base": obs["token_value_base"], "max_steps": max_steps,
        "type_names": tuple(sorted({"agent", *spec["objects"]})),
    }
    found = {k: getattr(program, k) for k in stated}
    found["type_names"] = tuple(sorted(found["type_names"]))
    found["action_names"], found["resource_names"] = tuple(found["action_names"]), tuple(found["resource_names"])
    for flag, on in obs["global_obs"].items():
        stated[f"global_obs.{flag}"] = on
        found[f"global_obs.{flag}"] = bool(getattr(program.global_obs, flag))
    stated["agent_group"] = spec["agent"]["group"]
    found["agent_group"] = int(np.asarray(program.agent_groups)[0])
    wrong = {k: (stated[k], found[k]) for k in stated if stated[k] != found[k]}
    if wrong:
        raise ValueError(f"the program does not run the configuration file: {wrong}")


class System:
    """The program for one cell: ``reset(seed)`` and ``step(state, actions,
    vibe_actions, perm, obs_buf, reset_maps)`` of make_step with auto-reset
    and the agent order given, on ``device``."""

    def __init__(self, config_name: str, spec: dict, max_steps: int, device):
        from mettagrid_tpu_torch.engine import build_env_init, compile_program, make_reset, make_step

        t0 = time.perf_counter()
        cfg = config_module(config_name).port_config(spec, max_steps)
        program = compile_program(cfg)
        _check_program(program, spec, max_steps)
        A = spec["num_agents"]
        builder = cfg.game.map_builder
        maps = [builder.model_copy(update={"seed": spec["pool_seed"] + i}).create().build_for_num_agents(A)
                for i in range(spec["pool"])]
        init = build_env_init(program, maps)
        self.map_pool_s = time.perf_counter() - t0
        self.program = program
        self.grids = [np.asarray(m.grid) for m in maps]
        self.objects = program.num_objects
        self.reset = make_reset(program, init, spec["envs"], device=device)
        self.step = make_step(program, init, auto_reset=True, external_perm=True, device=device)

    @staticmethod
    def outputs(out, rows: torch.Tensor) -> dict:
        """A step's outputs for the envs ``rows``, gathered on the device
        without waiting for it."""
        return {k: getattr(out, k)[rows] for k in OUTPUTS}

    def results(self, state, out, rows: torch.Tensor) -> dict:
        """The named results of the envs ``rows`` (numpy), as the plain
        reference names them."""
        from mettagrid_tpu_torch.engine.program import AUTO_STAT_BASE

        p, A = self.program, self.program.num_agents

        def take(t):
            return t[rows].cpu().numpy()

        pos_r, pos_c = take(state.obj_r[:, :A]), take(state.obj_c[:, :A])
        # The action phase may leave the grid's agent layer stale (the lazy
        # grid): keep its other objects and place the agents where they are.
        grid = take(state.grid)
        grid = np.where(grid >= A, grid, -1)
        S = grid.shape[0]
        grid[np.arange(S)[:, None], pos_r, pos_c] = np.arange(A)[None, :]
        res = {
            **{k: v.cpu().numpy() for k, v in self.outputs(out, rows).items()},
            "positions": np.stack([pos_r, pos_c], axis=-1),
            "grid": grid,
            "episode_rewards": take(state.episode_rewards),
            "step_count": take(state.step_count),
            "map_idx": take(state.map_idx),
            "action_success": take(out.action_success),
        }
        agent_stats = take(state.agent_stats)
        for k, name in enumerate(p.agent_stat_names):
            res[f"agent_stat:{name}"] = agent_stats[:, :, k]
        auto = take(state.auto_stats)
        for name, sid in (("cell.visited", p.stat_cell_visited), ("cell.unique_visited", p.stat_cell_unique),
                          ("cell.max_distance_from_spawn", p.stat_cell_maxdist)):
            res[f"agent_stat:{name}"] = auto[:, :, sid - AUTO_STAT_BASE] if p.stats_compact else agent_stats[:, :, sid]
        game = take(state.game_stats)
        for name, sid in (("tokens_written", p.stat_tokens_written), ("tokens_dropped", p.stat_tokens_dropped),
                          ("tokens_free_space", p.stat_tokens_free)):
            res[f"game_stat:{name}"] = game[:, sid]
        return res
