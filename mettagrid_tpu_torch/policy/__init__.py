"""The policy layer on the card (reference: mettagrid_tpu/policy/).

Policies are torch modules over the batched token observations on their
device: (E, A, T, 3) uint8 in, (E, A, n_actions) logits out, the recurrent
state kept beside the net. Their parameters move to and from the JAX
package's flax trees through policy/interop.py.
"""

from mettagrid_tpu_torch.policy.loader import (
    discover_and_register_policies,
    get_policy_class_shorthand,
    initialize_or_load_policy,
    resolve_policy_class_path,
)
from mettagrid_tpu_torch.policy.interop import (
    opt_state_from_optax,
    opt_state_to_optax,
    params_from_flax,
    params_to_flax,
)
from mettagrid_tpu_torch.policy.lstm import LSTMPolicy, LSTMState, init_policy, unroll
from mettagrid_tpu_torch.policy.policy import (
    POLICY_REGISTRY,
    AgentPolicy,
    MultiAgentPolicy,
    NoopMultiAgentPolicy,
    PolicySpec,
    RandomMultiAgentPolicy,
    StatefulAgentPolicy,
    StatefulPolicyImpl,
    TorchMultiAgentPolicy,
    load_policy,
)
from mettagrid_tpu_torch.policy.policy_env_interface import PolicyEnvInterface
from mettagrid_tpu_torch.policy.prepare_policy_spec import (
    load_policy_spec_from_path,
    localize_policy_uri,
    prepare_policy_spec,
)
from mettagrid_tpu_torch.policy.puffer_default import PufferDefaultNet, PufferDefaultPolicy
from mettagrid_tpu_torch.policy.stateless import StatelessPolicy, StatelessPolicyNet
from mettagrid_tpu_torch.policy.submission import (
    SubmissionPolicySpec,
    load_policy_manifest,
    write_submission_policy_spec,
)
from mettagrid_tpu_torch.policy.token_encoder import TokenEncoder

__all__ = [
    "POLICY_REGISTRY",
    "AgentPolicy",
    "LSTMPolicy",
    "LSTMState",
    "MultiAgentPolicy",
    "NoopMultiAgentPolicy",
    "PolicyEnvInterface",
    "PolicySpec",
    "PufferDefaultNet",
    "PufferDefaultPolicy",
    "RandomMultiAgentPolicy",
    "StatefulAgentPolicy",
    "StatefulPolicyImpl",
    "StatelessPolicy",
    "StatelessPolicyNet",
    "SubmissionPolicySpec",
    "TokenEncoder",
    "TorchMultiAgentPolicy",
    "discover_and_register_policies",
    "get_policy_class_shorthand",
    "init_policy",
    "initialize_or_load_policy",
    "load_policy",
    "load_policy_manifest",
    "load_policy_spec_from_path",
    "localize_policy_uri",
    "opt_state_from_optax",
    "opt_state_to_optax",
    "params_from_flax",
    "params_to_flax",
    "prepare_policy_spec",
    "resolve_policy_class_path",
    "unroll",
    "write_submission_policy_spec",
]
