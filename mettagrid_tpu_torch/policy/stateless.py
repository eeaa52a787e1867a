"""Stateless feedforward policy (reference: mettagrid_tpu/policy/stateless.py).

Flatten/255 -> Linear(128) -> ReLU -> Linear -> action/value heads, stepped
for the whole agent batch in one call. The first layer's input width
(T * 3) is the first batch's, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mettagrid_tpu_torch.engine.state import resolve_device
from mettagrid_tpu_torch.policy.interop import init_like_flax, params_from_flax, params_to_flax
from mettagrid_tpu_torch.policy.policy import (
    MultiAgentPolicy,
    as_tokens,
    generators,
    load_tree,
    num_actions_of,
    sample_actions,
    save_tree,
    write_actions,
)
from mettagrid_tpu_torch.policy.puffer_default import flatten_tokens


class StatelessPolicyNet(nn.Module):
    """Flattened-token MLP actor-critic over ``obs_size`` = T * 3 inputs."""

    # flax's names for the four compact Dense layers.
    FLAX_NAMES = {"Dense_0": "hidden", "Dense_1": "out", "Dense_2": "action_head", "Dense_3": "value_head"}

    def __init__(self, num_actions: int, obs_size: int, hidden_size: int = 128, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = nn.Linear(obs_size, hidden_size, device=device)
        self.out = nn.Linear(hidden_size, hidden_size, device=device)
        self.action_head = nn.Linear(hidden_size, num_actions, device=device)
        self.value_head = nn.Linear(hidden_size, 1, device=device)
        if generator is not None:
            init_like_flax(self, generator)

    def forward(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens: uint8[..., T, 3] -> (logits[..., A], value[...])."""
        x = self.out(torch.relu(self.hidden(flatten_tokens(tokens))))
        return self.action_head(x), self.value_head(x)[..., 0]


class StatelessPolicy(MultiAgentPolicy):
    """Batched stateless policy behind the buffer protocol."""

    short_name = "stateless"

    def __init__(self, policy_env_info=None, num_actions: Optional[int] = None, seed: int = 0, device=None):
        super().__init__(policy_env_info)
        self._device = resolve_device(device)
        self._num_actions = num_actions_of(policy_env_info, num_actions)
        self._init_gen, self._generator = generators(seed, self._device)
        self._net: Optional[StatelessPolicyNet] = None

    def _build(self, obs_size: int, hidden_size: int = 128, generator=None) -> StatelessPolicyNet:
        self._net = StatelessPolicyNet(self._num_actions, obs_size, hidden_size, device=self._device,
                                       generator=generator)
        return self._net

    def network(self) -> Optional[StatelessPolicyNet]:
        return self._net

    def is_recurrent(self) -> bool:
        return False

    def step_batch(self, raw_observations, raw_actions) -> None:
        tokens = as_tokens(raw_observations, self._device)
        if self._net is None:
            self._build(tokens.shape[-2] * 3, generator=self._init_gen)
        with torch.no_grad():
            logits, _ = self._net(tokens)
            write_actions(sample_actions(logits, self._generator), raw_actions)

    def save_policy_data(self, policy_data_path: str) -> None:
        save_tree(policy_data_path, params_to_flax(self._net))

    def load_policy_data(self, policy_data_path: str) -> None:
        tree = load_tree(policy_data_path)
        obs_size, hidden_size = tree["params"]["Dense_0"]["kernel"].shape
        params_from_flax(self._build(obs_size, hidden_size), tree)
