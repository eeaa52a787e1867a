"""The port's policy servers (mettagrid_tpu_torch/runner/policy_server/),
on the CPU over real WebSockets on 127.0.0.1.

- Twins of tests/runner/test_policy_server.py and
  test_policy_server_protobuf.py: the action-id encoding, the JSON and the
  sim.policy_v1 protobuf round trips, and the checked-in ``policy_v1_pb2.py``
  against protoc's output for the checked-in ``.proto``.
- The generated module is the JAX package's byte for byte, so both import
  into one process and share their message classes.
- Across packages, in both directions and for both protocols: the port's
  client against the JAX package's server and the JAX client against the
  port's server, each serving the same deterministic policy, must return
  the actions that policy computes in process.
- The port's ``lstm`` policy on the CPU behind the JSON and the protobuf
  server: every request's actions equal an in-process twin's (same seed,
  same device, the same observations).

Tolerance: exact (actions are integers).
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import mettagrid_tpu.runner.policy_server as jserver
import mettagrid_tpu_torch.runner.policy_server as tserver
from mettagrid_tpu.policy.policy import MultiAgentPolicy as JaxMultiAgentPolicy
from mettagrid_tpu.runner.policy_server import policy_v1_pb2 as jpb
from mettagrid_tpu_torch.policy import PolicyEnvInterface, TorchMultiAgentPolicy
from mettagrid_tpu_torch.policy.policy import MultiAgentPolicy, RandomMultiAgentPolicy
from mettagrid_tpu_torch.runner.policy_server import (
    LocalPolicyServer,
    PolicyStepError,
    ProtobufPolicyServer,
    ProtobufRemotePolicy,
    RemotePolicy,
    decode_action_id,
    encode_action,
)
from mettagrid_tpu_torch.runner.policy_server import policy_v1_pb2 as pb

REPO = Path(__file__).resolve().parents[1]
PRIMARY = ["noop", "move_north", "move_east"]
VIBES = ["change_vibe_default", "change_vibe_angry"]
N_ACTIONS = 5


def test_action_id_decode_ranges():
    assert decode_action_id(1, PRIMARY, VIBES).primary == "move_north"
    assert decode_action_id(3, PRIMARY, VIBES).vibe == "change_vibe_default"
    combined = decode_action_id(len(PRIMARY) + len(VIBES) + 1 * 2 + 1, PRIMARY, VIBES)
    assert combined.primary == "move_north" and combined.vibe == "change_vibe_angry"
    with pytest.raises(PolicyStepError):
        decode_action_id(len(PRIMARY) + len(VIBES) + 6, PRIMARY, VIBES)
    with pytest.raises(PolicyStepError):
        decode_action_id(-1, PRIMARY, VIBES)


def test_action_id_roundtrip():
    P, V = len(PRIMARY), len(VIBES)
    for p in range(P):
        for v in range(V):
            decoded = decode_action_id(encode_action(p, v, P, V), PRIMARY, VIBES)
            assert decoded.primary == PRIMARY[p] and decoded.vibe == VIBES[v]
        assert decode_action_id(encode_action(p, None, P, V), PRIMARY, VIBES).primary == PRIMARY[p]
    for v in range(V):
        assert decode_action_id(encode_action(None, v, P, V), PRIMARY, VIBES).vibe == VIBES[v]


def test_websocket_roundtrip():
    server = LocalPolicyServer(RandomMultiAgentPolicy(num_actions=3, seed=7))
    server.start()
    try:
        client = RemotePolicy(server.uri, num_tokens=8)
        obs = np.full((2, 8, 3), 0xFF, dtype=np.uint8)
        acts = np.zeros(2, dtype=np.int32)
        client.step_batch(obs, acts)
        assert acts.max() < 3
        client.reset()
        client.step_batch(obs, acts)
        client.close()
    finally:
        server.stop()


def test_protobuf_roundtrip():
    server = ProtobufPolicyServer(RandomMultiAgentPolicy(num_actions=3, seed=7), num_tokens=8)
    server.start()
    try:
        client = ProtobufRemotePolicy(server.uri, agent_ids=[0, 1])
        obs = np.full((2, 8, 3), 0xFF, dtype=np.uint8)
        acts = np.zeros(2, dtype=np.int32)
        client.step_batch(obs, acts)
        assert acts.max() < 3
        client.step_batch(obs, acts)
        client.close()
    finally:
        server.stop()


def test_proto_staleness(tmp_path):
    """The checked-in policy_v1_pb2.py is protoc's output for the checked-in
    .proto, and both are the JAX package's wire schema: the generated module
    is the JAX package's byte for byte."""
    src = REPO / "mettagrid_tpu_torch/runner/policy_server/policy_v1.proto"
    subprocess.run(["protoc", f"--python_out={tmp_path}", "-I", str(src.parent), str(src)], check=True)
    checked_in = (REPO / "mettagrid_tpu_torch/runner/policy_server/policy_v1_pb2.py").read_bytes()
    assert (tmp_path / "policy_v1_pb2.py").read_bytes() == checked_in
    assert checked_in == (REPO / "mettagrid_tpu/runner/policy_server/policy_v1_pb2.py").read_bytes()


def test_descriptor_shared_with_jax_package():
    assert pb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert pb.DESCRIPTOR.package == "mettagrid_tpu.sim.policy_v1"
    assert pb.BatchStepRequest is jpb.BatchStepRequest and pb.PreparePolicyRequest is jpb.PreparePolicyRequest
    msg = pb.BatchStepRequest(episode_id="e", step_id=3, agent_observations=[pb.AgentObservations(agent_id=1)])
    assert jpb.BatchStepRequest.FromString(msg.SerializeToString()) == msg


def _digest_actions(obs: np.ndarray) -> np.ndarray:
    """A deterministic policy: each agent's action from its observation bytes."""
    weights = np.arange(1, obs.shape[-2] * 3 + 1, dtype=np.int64).reshape(obs.shape[-2], 3)
    return ((obs.astype(np.int64) * weights).sum(axis=(-2, -1)) % N_ACTIONS).astype(np.int32)


class DigestPolicy(MultiAgentPolicy):
    def step_batch(self, raw_observations, raw_actions) -> None:
        raw_actions[...] = _digest_actions(np.asarray(raw_observations))


class JaxDigestPolicy(JaxMultiAgentPolicy):
    def step_batch(self, raw_observations, raw_actions) -> None:
        raw_actions[...] = _digest_actions(np.asarray(raw_observations))


def _observations(rng, A=3, T=8):
    obs = rng.integers(0, 256, (A, T, 3)).astype(np.uint8)
    obs[:, T - 2:] = 0xFF
    return obs


@pytest.mark.parametrize("protocol", ["json", "protobuf"])
@pytest.mark.parametrize("direction", ["port client, JAX server", "JAX client, port server"])
def test_across_packages(protocol, direction):
    port_client = direction.startswith("port")
    servers = jserver if port_client else tserver
    clients = tserver if port_client else jserver
    policy = JaxDigestPolicy() if port_client else DigestPolicy()
    if protocol == "json":
        server = servers.LocalPolicyServer(policy)
    else:
        server = servers.ProtobufPolicyServer(policy, num_tokens=8)
    server.start()
    try:
        if protocol == "json":
            client = clients.RemotePolicy(server.uri, num_tokens=8)
        else:
            client = clients.ProtobufRemotePolicy(server.uri, agent_ids=[0, 1, 2])
        rng = np.random.default_rng(17)
        for _ in range(4):
            obs = _observations(rng)
            acts = np.full(3, -1, dtype=np.int32)
            client.step_batch(obs, acts)
            np.testing.assert_array_equal(acts, _digest_actions(obs))
        client.close()
    finally:
        server.stop()


def _arena_observations(steps: int):
    """Observations of a four-agent arena under random actions, on the CPU."""
    from mettagrid_tpu_torch.simulator import Simulation
    from tests.test_torch_simulation import arena

    sim = Simulation(arena(), seed=9, device="cpu")
    rng = np.random.default_rng(9)
    out = []
    for _ in range(steps):
        out.append(sim.last_outputs.observations[0].numpy().copy())
        for a in range(sim.num_agents):
            sim.agent(a).set_action(int(rng.integers(0, len(sim.action_names))))
        sim.step()
    return sim.config, out


@pytest.mark.parametrize("protocol", ["json", "protobuf"])
def test_lstm_policy_served_equals_in_process(protocol):
    cfg, frames = _arena_observations(6)
    info = PolicyEnvInterface.from_config(cfg)
    served = TorchMultiAgentPolicy(info, seed=21, device="cpu")
    twin = TorchMultiAgentPolicy(info, seed=21, device="cpu")
    for p, q in zip(served.network().parameters(), twin.network().parameters()):
        assert torch.equal(p, q)
    if protocol == "json":
        server = LocalPolicyServer(served)
    else:
        server = ProtobufPolicyServer(served, num_tokens=frames[0].shape[1])
    server.start()
    try:
        if protocol == "json":
            client = RemotePolicy(server.uri, num_tokens=frames[0].shape[1])
        else:
            client = ProtobufRemotePolicy(server.uri, info, agent_ids=list(range(len(frames[0]))))
        twin.reset()
        for obs in frames:
            got = np.full(len(obs), -1, dtype=np.int32)
            want = np.full(len(obs), -1, dtype=np.int32)
            client.step_batch(obs, got)
            twin.step_batch(obs, want)
            np.testing.assert_array_equal(got, want)
            assert 0 <= got.min() and got.max() < len(info.action_names)
        client.close()
    finally:
        server.stop()
