"""Protocol observation tokens (``protocol_details_obs``) in the port against
the JAX engine.

Forges carry a Protocol, so observers see one protocol_input:<res> /
protocol_output:<res> token per recipe resource, valued quantity % base.
A 30-step lockstep (3 agents, 4 envs, auto-reset every 8 steps) from the
JAX reset state, fed the same actions and agent orders, in token value
bases 256 and 10 (12 and 263 wrap in base 10, 263 in base 256); every
output and every state field but rng must be equal after every step
(exact).
"""

import importlib

import numpy as np
import pytest

import mettagrid_tpu.engine as jengine
from mettagrid_tpu_torch import engine as tengine
from tests.test_torch_step import lockstep_pair

A = 3


def _cfg(pkg: str, base: int):
    imp = importlib.import_module
    gc = imp(f"{pkg}.config.game_config")
    Protocol = imp(f"{pkg}.config.protocol").Protocol
    RandomMapBuilder = imp(f"{pkg}.maps.random_map").RandomMapBuilder
    forge = Protocol(input_resources={"ore_red": 12, "heart": 3}, output_resources={"heart": 263}, cooldown=2)
    cfg = gc.MettaGridConfig(game=gc.GameConfig(
        num_agents=A,
        max_steps=8,
        resource_names=["ore_red", "heart"],
        objects={"wall": gc.WallConfig(), "forge": gc.GridObjectConfig(name="forge", protocol=forge),
                 "altar": gc.GridObjectConfig(name="altar", protocol=Protocol(output_resources={"ore_red": 1}))},
        map_builder=RandomMapBuilder.Config(agents=A, width=7, height=7, border_width=1, seed=2,
                                            objects={"forge": 3, "altar": 2, "wall": 2}),
        protocol_details_obs=True,
    ))
    cfg.game.obs.token_value_base = base
    return cfg


def _pair(eng, pkg, base):
    cfg = _cfg(pkg, base)
    program = eng.compile_program(cfg)
    return program, eng.build_env_init(program, [cfg.game.map_builder.create().build_for_num_agents(A)])


@pytest.mark.parametrize("base", [256, 10])
def test_protocol_tokens_match_jax(base):
    jp, ji = _pair(jengine, "mettagrid_tpu", base)
    tp, ti = _pair(tengine, "mettagrid_tpu_torch", base)
    feats = {f.name: f.id for f in _cfg("mettagrid_tpu_torch", base).game.id_map().features()}
    fid = feats["protocol_output:heart"]
    _, out = tengine.make_reset(tp, ti, 4, device="cpu")(0)
    obs = out.observations.numpy()
    vals = obs[..., 2][obs[..., 1] == fid]
    # The forges' recipe tokens are seen, valued 263 % base.
    assert vals.size > 0 and (vals == 263 % base).all()
    assert lockstep_pair((jp, ji), (tp, ti), num_envs=4, n_steps=30, seed=base) >= 12
