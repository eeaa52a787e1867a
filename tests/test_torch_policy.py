"""The port's policy framework on the CPU: twins of tests/policy/test_policies.py
and tests/policy/test_policy_infra.py (registry, PolicySpec, load_policy,
the loader's shorthands, PolicyEnvInterface, submission archives, zip
traversal, prepare_policy_spec), and policy data files across the two
packages.

A policy data file saved by the JAX package's ``lstm``, ``puffer`` and
``stateless`` policies loads into the port's and gives the same logits,
values and state on the same tokens; a file saved by the port does the same
in the JAX package (atol = rtol = 1e-5, float32; tests/test_torch_policy_nets.py
says why the sums differ). Sampled actions are never compared: the port
draws from a torch.Generator, the JAX package from jax.random.
"""

import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mettagrid_tpu.config import MettaGridConfig as JMettaGridConfig
from mettagrid_tpu.policy import JaxMultiAgentPolicy
from mettagrid_tpu.policy import PolicyEnvInterface as JPolicyEnvInterface
from mettagrid_tpu.policy import PufferDefaultPolicy as JPufferDefaultPolicy
from mettagrid_tpu.policy import StatelessPolicy as JStatelessPolicy
from mettagrid_tpu.policy.lstm import LSTMState as JLSTMState
from mettagrid_tpu_torch.config import MettaGridConfig
from mettagrid_tpu_torch.config.game_config import GameConfig, WallConfig
from mettagrid_tpu_torch.maps.ascii import AsciiMapBuilder
from mettagrid_tpu_torch.policy import (
    POLICY_REGISTRY,
    LSTMState,
    NoopMultiAgentPolicy,
    PolicyEnvInterface,
    PolicySpec,
    PufferDefaultPolicy,
    RandomMultiAgentPolicy,
    StatelessPolicy,
    SubmissionPolicySpec,
    TorchMultiAgentPolicy,
    get_policy_class_shorthand,
    initialize_or_load_policy,
    load_policy,
    load_policy_manifest,
    load_policy_spec_from_path,
    prepare_policy_spec,
    resolve_policy_class_path,
    write_submission_policy_spec,
)
from mettagrid_tpu_torch.simulator.rollout import Rollout, single_episode_rollout

TOL = dict(atol=1e-5, rtol=1e-5)
NOOP = "mettagrid_tpu_torch.policy.policy.NoopMultiAgentPolicy"


class _EnvInfo:
    action_names = ["noop", "move_north", "move_south", "move_west", "move_east"]


def nav_config(max_steps=5):
    return MettaGridConfig(
        game=GameConfig(
            num_agents=2,
            max_steps=max_steps,
            objects={"wall": WallConfig()},
            map_builder=AsciiMapBuilder.Config(map_data=["######", "#@.@.#", "######"]),
        )
    )


@pytest.fixture(scope="module")
def env_info():
    return PolicyEnvInterface.from_config(MettaGridConfig.EmptyRoom(num_agents=2))


# --- twins of tests/policy/test_policies.py ---


def test_registry_contains_builtins():
    for name in ("random", "noop", "lstm", "puffer", "stateless"):
        assert name in POLICY_REGISTRY
    assert POLICY_REGISTRY["lstm"] is TorchMultiAgentPolicy


def test_policy_spec_loading():
    spec = PolicySpec(class_path="random", init_kwargs={"num_actions": 5, "seed": 1})
    policy = load_policy(spec)
    acts = np.zeros(4, dtype=np.int32)
    policy.step_batch(np.zeros((4, 10, 3), dtype=np.uint8), acts)
    assert acts.max() < 5
    lstm = load_policy(PolicySpec(class_path="lstm"), _EnvInfo(), device="cpu")
    assert lstm.network().pre.weight.device.type == "cpu"


def test_rollout_with_random_policy():
    result = single_episode_rollout(nav_config(), RandomMultiAgentPolicy(_EnvInfo()), device="cpu")
    assert result.steps == 5
    assert result.episode_rewards.shape == (2,)


def test_rollout_mixed_policies():
    rollout = Rollout(
        nav_config(),
        [(NoopMultiAgentPolicy(_EnvInfo()), [0]), (RandomMultiAgentPolicy(_EnvInfo()), [1])],
        device="cpu",
    )
    assert rollout.run().steps == 5


def test_torch_lstm_policy_steps(tmp_path):
    policy = TorchMultiAgentPolicy(_EnvInfo(), device="cpu")
    obs = np.zeros((2, 20, 3), dtype=np.uint8)
    obs[..., 0] = 0xFF
    acts = np.zeros(2, dtype=np.int32)
    policy.step_batch(obs, acts)
    assert acts.shape == (2,) and acts.max() < 5
    p = tmp_path / "params.pkl"
    policy.save_policy_data(str(p))
    policy2 = TorchMultiAgentPolicy(_EnvInfo(), seed=9, device="cpu")
    policy2.load_policy_data(str(p))
    for a, b in zip(policy.network().state_dict().values(), policy2.network().state_dict().values()):
        assert torch.equal(a, b)
    policy2.step_batch(obs, acts)


# --- twins of tests/policy/test_policy_infra.py ---


def test_env_interface_fields(env_info):
    assert env_info.num_agents == 2
    assert "noop" in env_info.action_names
    assert all(a.startswith("change_vibe_") for a in env_info.vibe_action_names)
    assert not any(a.startswith("change_vibe_") for a in env_info.action_names)
    assert env_info.observation_shape == (500, 3)
    assert env_info.obs_height == 13 and env_info.obs_width == 13
    assert len(env_info.obs_features) > 0
    assert env_info.observation_space.dtype == np.uint8
    assert env_info.action_space.n == len(env_info.action_names)
    jax_info = JPolicyEnvInterface.from_config(JMettaGridConfig.EmptyRoom(num_agents=2))
    assert env_info.model_dump(mode="json") == jax_info.model_dump(mode="json")


def test_env_interface_serialization_roundtrip(env_info):
    assert PolicyEnvInterface.model_validate_json(env_info.model_dump_json()) == env_info
    jax_info = JPolicyEnvInterface.model_validate_json(env_info.model_dump_json())
    assert PolicyEnvInterface.model_validate_json(jax_info.model_dump_json()) == env_info


def test_resolve_policy_class_path_shorthands():
    assert resolve_policy_class_path("random").endswith("RandomMultiAgentPolicy")
    assert resolve_policy_class_path("noop").endswith("NoopMultiAgentPolicy")
    assert resolve_policy_class_path("stateless").endswith("StatelessPolicy")
    assert resolve_policy_class_path("puffer").endswith("PufferDefaultPolicy")
    assert resolve_policy_class_path("lstm") == "mettagrid_tpu_torch.policy.policy.TorchMultiAgentPolicy"
    assert resolve_policy_class_path("a.b.C") == "a.b.C"


def test_shorthand_reverse_lookup():
    for short in ("stateless", "lstm", "puffer"):
        assert get_policy_class_shorthand(resolve_policy_class_path(short)) == short


def test_initialize_or_load_policy(env_info):
    policy = initialize_or_load_policy(env_info, PolicySpec(class_path="random"))
    acts = np.zeros(2, dtype=np.int32)
    policy.step_batch(np.zeros((2, 10, 3), dtype=np.uint8), acts)
    assert (acts >= 0).all() and (acts < len(env_info.action_names)).all()
    spec = PolicySpec(class_path="stateless", init_kwargs={"device": "cuda"})
    assert initialize_or_load_policy(env_info, spec, device_override="cpu")._device.type == "cpu"


def test_stateless_policy_steps_and_saves(env_info, tmp_path):
    policy = StatelessPolicy(env_info, seed=1, device="cpu")
    obs = np.random.default_rng(0).integers(0, 255, size=(2, 20, 3), dtype=np.uint8)
    acts = np.zeros(2, dtype=np.int32)
    policy.step_batch(obs, acts)
    assert not policy.is_recurrent()
    path = tmp_path / "stateless.pkl"
    policy.save_policy_data(str(path))
    policy2 = StatelessPolicy(env_info, seed=1, device="cpu")
    policy2.load_policy_data(str(path))
    acts2 = np.zeros(2, dtype=np.int32)
    policy2.step_batch(obs, acts2)
    assert (acts == acts2).all()  # same parameters, same draws


def test_puffer_default_policy_recurrent(env_info):
    policy = PufferDefaultPolicy(env_info, hidden_size=64, device="cpu")
    assert policy.is_recurrent()
    obs = np.zeros((2, 20, 3), dtype=np.uint8)
    acts = np.zeros(2, dtype=np.int32)
    policy.step_batch(obs, acts)
    assert policy._state is not None and policy.network().encoder.in_features == 60
    policy.reset()
    assert policy._state is None


def _write_archive(tmp_path: Path, with_manifest: bool) -> Path:
    root = tmp_path / "bundle"
    root.mkdir()
    if with_manifest:
        (root / "mettagrid.toml").write_text(f'[policy]\nclass_path = "{NOOP}"\n')
    else:
        write_submission_policy_spec(root / "policy_spec.json", SubmissionPolicySpec(class_path=NOOP))
    archive = tmp_path / "bundle.zip"
    with zipfile.ZipFile(archive, "w") as zf:
        for f in root.iterdir():
            zf.write(f, f.name)
    return archive


def test_submission_archive_spec_json(tmp_path, env_info):
    spec = load_policy_spec_from_path(_write_archive(tmp_path, with_manifest=False), force_dest=tmp_path / "x")
    assert spec.class_path == NOOP
    policy = initialize_or_load_policy(env_info, spec)
    acts = np.ones(2, dtype=np.int32)
    policy.step_batch(np.zeros((2, 5, 3), dtype=np.uint8), acts)
    assert (acts == 0).all()


def test_submission_archive_manifest(tmp_path):
    spec = load_policy_spec_from_path(_write_archive(tmp_path, with_manifest=True), force_dest=tmp_path / "x")
    assert spec.class_path == NOOP


def test_manifest_requires_policy_table(tmp_path):
    path = tmp_path / "bad.toml"
    path.write_text("[other]\nx = 1\n")
    with pytest.raises(ValueError, match="policy"):
        load_policy_manifest(path)


def test_zip_traversal_rejected(tmp_path):
    archive = tmp_path / "evil.zip"
    with zipfile.ZipFile(archive, "w") as zf:
        zf.writestr("../escape.txt", "nope")
    with pytest.raises(ValueError, match="escapes"):
        load_policy_spec_from_path(archive, force_dest=tmp_path / "extract")


def test_prepare_policy_spec_passthrough(tmp_path):
    assert prepare_policy_spec("random").class_path == "random"
    root = tmp_path / "bundle"
    root.mkdir()
    write_submission_policy_spec(root / "policy_spec.json", SubmissionPolicySpec(
        class_path="lstm", data_path="weights.pkl", init_kwargs={"device": "cuda"}))
    spec = prepare_policy_spec(str(root), device="cpu")
    assert spec.policy_data_path == str(root / "weights.pkl") and spec.init_kwargs == {"device": "cpu"}


def test_setup_script_runs_once(tmp_path):
    root = tmp_path / "bundle"
    root.mkdir()
    (root / "setup.py").write_text("open('setup_ran.txt', 'a').write('x')\n")
    write_submission_policy_spec(
        root / "policy_spec.json", SubmissionPolicySpec(class_path=NOOP, setup_script="setup.py")
    )
    load_policy_spec_from_path(root)
    load_policy_spec_from_path(root)
    assert (root / "setup_ran.txt").read_text() == "x"


# --- policy data files across the two packages ---

T_TOKENS = 20


def _tokens():
    rng = np.random.default_rng(7)
    tok = rng.integers(0, 256, (3, T_TOKENS, 3)).astype(np.uint8)
    tok[:, 15:, 0] = 0xFF
    return tok


def _jax_policy(kind):
    if kind == "lstm":
        return JaxMultiAgentPolicy(_EnvInfo(), seed=4)
    if kind == "puffer":
        return JPufferDefaultPolicy(_EnvInfo(), hidden_size=32, seed=4)
    return JStatelessPolicy(_EnvInfo(), seed=4)


def _port_policy(kind):
    if kind == "lstm":
        return TorchMultiAgentPolicy(_EnvInfo(), seed=4, device="cpu")
    if kind == "puffer":
        return PufferDefaultPolicy(_EnvInfo(), hidden_size=32, seed=4, device="cpu")
    return StatelessPolicy(_EnvInfo(), seed=4, device="cpu")


def _jax_forward(kind, policy, tok, state):
    """(logits, value, h, c) of the JAX policy's net from ``state``."""
    if kind == "stateless":
        logits, value = jax.jit(policy.network().apply)(policy._params, jnp.asarray(tok))
        return logits, value
    net = policy._policy if kind == "lstm" else policy.network()
    logits, value, new = jax.jit(net.apply)(policy._params, jnp.asarray(tok), JLSTMState(*map(jnp.asarray, state)))
    return logits, value, new.h, new.c


def _port_forward(kind, policy, tok, state):
    with torch.no_grad():
        if kind == "stateless":
            return policy.network()(torch.from_numpy(tok))
        logits, value, new = policy.network()(torch.from_numpy(tok), LSTMState(*map(torch.from_numpy, state)))
    return logits, value, new.h, new.c


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", ["lstm", "puffer", "stateless"])
def test_policy_data_file_moves_both_ways(kind, direction, tmp_path):
    """Either package's policy, initialised by a first step, saves its data;
    the other loads it, and both forward the same tokens from one random
    state to the same logits, values and state."""
    tok = _tokens()
    acts = np.zeros(3, np.int32)
    src, dst = (_jax_policy(kind), _port_policy(kind))
    if direction == "port_to_jax":
        src, dst = dst, src
    src.step_batch(tok, acts)
    path = tmp_path / "policy.pkl"
    src.save_policy_data(str(path))
    dst.load_policy_data(str(path))
    jpol, tpol = (src, dst) if direction == "jax_to_port" else (dst, src)
    hidden = {"lstm": 128, "puffer": 32, "stateless": 0}[kind]
    rng = np.random.default_rng(8)
    state = [rng.standard_normal((3, hidden)).astype(np.float32) for _ in range(2)]
    ref = _jax_forward(kind, jpol, tok, state)
    got = _port_forward(kind, tpol, tok, state)
    for what, g, r in zip(("logits", "value", "h", "c"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL, err_msg=f"{kind} {direction}: {what}")
