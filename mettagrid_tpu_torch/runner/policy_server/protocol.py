"""Policy-server wire protocol (reference: runner/policy_server/
websocket_transport.py + server.py).

Observations travel as raw 3-byte token triplets; actions come back as
combined action ids. The reference frames messages with protobuf
(sim.policy_v1); here frames are JSON with base64 triplet payloads — the
action-id encoding (primary / vibe / combined primary x vibe) matches the
reference exactly (websocket_transport.py:35-67).
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass
from typing import Optional

import numpy as np


class PolicyStepError(Exception):
    pass


def serialize_triplets(obs_tokens: np.ndarray) -> bytes:
    """uint8[T, 3] -> raw bytes (padding 0xFF rows included)."""
    return np.ascontiguousarray(obs_tokens, dtype=np.uint8).tobytes()


def parse_triplets(data: bytes) -> np.ndarray:
    arr = np.frombuffer(data, dtype=np.uint8)
    if len(arr) % 3:
        arr = arr[: len(arr) - len(arr) % 3]
    return arr.reshape(-1, 3)


@dataclass(frozen=True)
class DecodedAction:
    primary: Optional[str] = None
    vibe: Optional[str] = None


def decode_action_id(action_id: int, primary_names: list[str], vibe_names: list[str]) -> DecodedAction:
    """Combined action-id decode (websocket_transport.py:35-67):
    [0, P) -> primary; [P, P+V) -> vibe; [P+V, P+V+P*V) -> primary x vibe."""
    P, V = len(primary_names), len(vibe_names)
    if action_id < 0:
        raise PolicyStepError(f"invalid action_id {action_id}")
    if action_id < P:
        return DecodedAction(primary=primary_names[action_id])
    if V <= 0:
        raise PolicyStepError(f"invalid action_id {action_id}; expected [0, {P - 1}]")
    if action_id < P + V:
        return DecodedAction(vibe=vibe_names[action_id - P])
    encoded = action_id - P - V
    if encoded >= P * V:
        raise PolicyStepError(f"invalid action_id {action_id}; expected [0, {P + V + P * V - 1}]")
    return DecodedAction(primary=primary_names[encoded // V], vibe=vibe_names[encoded % V])


def encode_action(primary_idx: Optional[int], vibe_idx: Optional[int], P: int, V: int) -> int:
    if primary_idx is not None and vibe_idx is not None:
        return P + V + primary_idx * V + vibe_idx
    if vibe_idx is not None:
        return P + vibe_idx
    return primary_idx or 0


# ---- JSON frame helpers ----


def encode_frame(msg_type: str, **fields) -> str:
    payload = {"type": msg_type}
    for k, v in fields.items():
        if isinstance(v, bytes):
            payload[k] = base64.b64encode(v).decode("ascii")
        else:
            payload[k] = v
    return json.dumps(payload)


def decode_frame(raw: str | bytes) -> dict:
    return json.loads(raw)


def b64_bytes(frame: dict, key: str) -> bytes:
    return base64.b64decode(frame[key])
