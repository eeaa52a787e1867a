"""WebSocket policy server: out-of-process policies
(reference: mettagrid_tpu/runner/policy_server/server.py).

Message flow (one connection per episode):
  -> {"type": "prepare", "num_agents": N, "action_names": [...]}
  <- {"type": "ready"}
  -> {"type": "step", "step": t, "observations": {agent_id: b64 triplets}}
  <- {"type": "actions", "actions": {agent_id: action_id}}
  -> {"type": "reset"} / {"type": "close"}

The served policy runs where it was made: a TorchMultiAgentPolicy on the
card takes each request's observations to the card in one copy, forwards
once and brings the actions back in one copy. ``websockets`` and
``google.protobuf`` are imported inside the methods that use them, so that
importing this module needs neither. ``policy_v1_pb2`` registers the proto
package ``mettagrid_tpu.sim.policy_v1``: that is the wire schema's name,
shared with the JAX package's generated module (policy_v1.proto says why),
not an import of it.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from mettagrid_tpu_torch.policy.policy import MultiAgentPolicy
from mettagrid_tpu_torch.runner.policy_server.protocol import (
    b64_bytes,
    decode_frame,
    encode_frame,
    parse_triplets,
)


class LocalPolicyServer:
    """Serves one MultiAgentPolicy over WebSocket in a background thread."""

    def __init__(self, policy: MultiAgentPolicy, host: str = "127.0.0.1", port: int = 0):
        self._policy = policy
        self._host = host
        self._port = port
        self._server = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        assert self._server is not None, "server not started"
        return self._server.socket.getsockname()[1]

    @property
    def uri(self) -> str:
        return f"ws://{self._host}:{self.port}"

    def start(self) -> None:
        from websockets.sync.server import serve

        self._server = serve(self._handle, self._host, self._port)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _handle(self, ws) -> None:
        num_tokens = 0
        for raw in ws:
            frame = decode_frame(raw)
            t = frame["type"]
            if t == "prepare":
                num_tokens = frame.get("num_tokens", 0)
                self._policy.reset()
                ws.send(encode_frame("ready"))
            elif t == "step":
                obs_map = frame["observations"]
                agent_ids = sorted(int(a) for a in obs_map)
                obs_rows = []
                for a in agent_ids:
                    trip = parse_triplets(b64_bytes(obs_map, str(a)))
                    if num_tokens and len(trip) < num_tokens:
                        pad = np.full((num_tokens - len(trip), 3), 0xFF, dtype=np.uint8)
                        trip = np.concatenate([trip, pad])
                    obs_rows.append(trip)
                obs = np.stack(obs_rows)
                actions = np.zeros(len(agent_ids), dtype=np.int32)
                self._policy.step_batch(obs, actions)
                ws.send(
                    encode_frame(
                        "actions",
                        actions={str(a): int(actions[i]) for i, a in enumerate(agent_ids)},
                    )
                )
            elif t == "reset":
                self._policy.reset()
                ws.send(encode_frame("ready"))
            elif t == "close":
                ws.send(encode_frame("closed"))
                return
            else:
                ws.send(encode_frame("error", message=f"unknown message type {t!r}"))


class RemotePolicy(MultiAgentPolicy):
    """Client-side adapter: a MultiAgentPolicy that queries a policy server
    (reference: the transport side of websocket_transport.py)."""

    def __init__(self, uri: str, policy_env_info=None, num_tokens: int = 0):
        super().__init__(policy_env_info)
        from websockets.sync.client import connect

        self._ws = connect(uri)
        self._step = 0
        self._ws.send(encode_frame("prepare", num_tokens=num_tokens))
        frame = decode_frame(self._ws.recv())
        assert frame["type"] == "ready", frame

    def reset(self) -> None:
        self._ws.send(encode_frame("reset"))
        decode_frame(self._ws.recv())
        self._step = 0

    def step_batch(self, raw_observations: np.ndarray, raw_actions: np.ndarray) -> None:
        import base64

        obs_map = {
            str(a): base64.b64encode(
                np.ascontiguousarray(raw_observations[a], dtype=np.uint8).tobytes()
            ).decode("ascii")
            for a in range(raw_observations.shape[0])
        }
        self._ws.send(encode_frame("step", step=self._step, observations=obs_map))
        frame = decode_frame(self._ws.recv())
        if frame["type"] != "actions":
            raise RuntimeError(f"policy server error: {frame}")
        for a_str, action in frame["actions"].items():
            raw_actions[int(a_str)] = action
        self._step += 1

    def close(self) -> None:
        try:
            self._ws.send(encode_frame("close"))
            self._ws.recv()
        finally:
            self._ws.close()


# ---------------------------------------------------------------------
# sim.policy_v1 protobuf framing — wire-compatible with reference clients
# (reference: runner/policy_server/websocket_transport.py:27-67; framing:
# JSON PreparePolicyRequest text frame, then binary BatchStepRequest/
# BatchStepResponse until disconnect).
# ---------------------------------------------------------------------


class ProtobufPolicyServer:
    """Serves one MultiAgentPolicy over the sim.policy_v1 wire protocol."""

    def __init__(self, policy: MultiAgentPolicy, host: str = "127.0.0.1", port: int = 0,
                 num_tokens: int = 0):
        self._policy = policy
        self._host = host
        self._port = port
        self._num_tokens = num_tokens
        self._server = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        assert self._server is not None, "server not started"
        return self._server.socket.getsockname()[1]

    @property
    def uri(self) -> str:
        return f"ws://{self._host}:{self.port}"

    def start(self) -> None:
        from websockets.sync.server import serve

        self._server = serve(self._handle, self._host, self._port)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _handle(self, ws) -> None:
        from google.protobuf import json_format

        from mettagrid_tpu_torch.runner.policy_server import policy_v1_pb2 as pb

        prepare_raw = ws.recv()
        if not isinstance(prepare_raw, str):
            raise RuntimeError("expected JSON PreparePolicyRequest text frame")
        req = json_format.Parse(prepare_raw, pb.PreparePolicyRequest())
        self._policy.reset()
        ws.send(json_format.MessageToJson(pb.PreparePolicyResponse(), preserving_proto_field_name=True))

        for message in ws:
            if not isinstance(message, bytes):
                raise RuntimeError("expected binary BatchStepRequest frame")
            step_req = pb.BatchStepRequest.FromString(message)
            if step_req.episode_id != req.episode_id:
                raise RuntimeError(
                    f"episode_id {step_req.episode_id!r} != prepared {req.episode_id!r}"
                )
            agent_ids = [ao.agent_id for ao in step_req.agent_observations]
            rows = []
            for ao in step_req.agent_observations:
                trip = parse_triplets(ao.observations)
                if self._num_tokens and len(trip) < self._num_tokens:
                    pad = np.full((self._num_tokens - len(trip), 3), 0xFF, dtype=np.uint8)
                    trip = np.concatenate([trip, pad])
                rows.append(trip)
            obs = np.stack(rows)
            actions = np.zeros(len(agent_ids), dtype=np.int32)
            self._policy.step_batch(obs, actions)
            resp = pb.BatchStepResponse(
                agent_actions=[
                    pb.AgentActions(agent_id=a, action_id=[int(actions[i])])
                    for i, a in enumerate(agent_ids)
                ]
            )
            ws.send(resp.SerializeToString())


class ProtobufRemotePolicy(MultiAgentPolicy):
    """Client-side MultiAgentPolicy speaking sim.policy_v1 to any compliant
    policy server (ours or the reference's)."""

    def __init__(self, uri: str, policy_env_info=None, agent_ids=None,
                 episode_id: str = "ws-episode"):
        super().__init__(policy_env_info)
        from google.protobuf import json_format
        from websockets.sync.client import connect

        from mettagrid_tpu_torch.runner.policy_server import policy_v1_pb2 as pb

        self._pb = pb
        self._ws = connect(uri)
        self._episode_id = episode_id
        self._next_step_id = 0
        game_rules = pb.GameRules()
        env_iface = pb.PolicyEnvInterface()
        if policy_env_info is not None:
            for f in getattr(policy_env_info, "obs_features", []):
                feat = pb.GameRules.Feature(id=f.id, name=f.name, normalization=f.normalization)
                game_rules.features.append(feat)
                env_iface.obs_features.append(feat)
            names = list(getattr(policy_env_info, "action_names", []))
            for i, name in enumerate(names):
                game_rules.actions.append(pb.GameRules.Action(id=i, name=name))
            env_iface.action_names.extend(names)
        req = pb.PreparePolicyRequest(
            episode_id=episode_id,
            game_rules=game_rules,
            agent_ids=list(agent_ids or []),
            observations_format=pb.AgentObservations.TRIPLET_V1,
            env_interface=env_iface,
        )
        # The reference's schema pins json_name to snake_case, and
        # json_format.Parse only accepts json_name or the original field
        # name — so emit snake_case (original names) for interop.
        self._ws.send(json_format.MessageToJson(req, preserving_proto_field_name=True))
        self._ws.recv()  # PreparePolicyResponse

    def step_batch(self, raw_observations: np.ndarray, raw_actions: np.ndarray) -> None:
        pb = self._pb
        req = pb.BatchStepRequest(
            episode_id=self._episode_id,
            step_id=self._next_step_id,
            agent_observations=[
                pb.AgentObservations(
                    agent_id=a,
                    observations=np.ascontiguousarray(
                        raw_observations[a], dtype=np.uint8
                    ).tobytes(),
                )
                for a in range(raw_observations.shape[0])
            ],
        )
        self._next_step_id += 1
        self._ws.send(req.SerializeToString())
        resp = pb.BatchStepResponse.FromString(self._ws.recv())
        for aa in resp.agent_actions:
            if len(aa.action_id) != 1:
                raise RuntimeError(f"agent {aa.agent_id} returned {len(aa.action_id)} actions")
            raw_actions[aa.agent_id] = aa.action_id[0]

    def close(self) -> None:
        self._ws.close()
