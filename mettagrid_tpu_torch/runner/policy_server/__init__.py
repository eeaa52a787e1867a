"""Out-of-process policy serving (reference: runner/policy_server/)."""

from mettagrid_tpu_torch.runner.policy_server.protocol import (
    DecodedAction,
    PolicyStepError,
    decode_action_id,
    encode_action,
)
from mettagrid_tpu_torch.runner.policy_server.server import (
    LocalPolicyServer,
    ProtobufPolicyServer,
    ProtobufRemotePolicy,
    RemotePolicy,
)

__all__ = [
    "ProtobufPolicyServer",
    "ProtobufRemotePolicy",
    "DecodedAction",
    "LocalPolicyServer",
    "PolicyStepError",
    "RemotePolicy",
    "decode_action_id",
    "encode_action",
]
