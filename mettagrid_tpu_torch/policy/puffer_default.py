"""PufferLib-default-style architecture (reference:
mettagrid_tpu/policy/puffer_default.py).

Flatten/255, Linear encoder + GELU (flax's default, the tanh
approximation), a single-layer LSTM core (hidden 256) and a small-std
action head, with an explicit carried state, batched over all agents in
one call. The encoder's input width (T * 3) is the first batch's, as in
the JAX package: the policy builds its net at the first step (or from the
tree it loads).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mettagrid_tpu_torch.engine.state import resolve_device
from mettagrid_tpu_torch.policy.interop import init_like_flax, params_from_flax, params_to_flax
from mettagrid_tpu_torch.policy.lstm import LSTMState, lstm_step, zero_state
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


def flatten_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """uint8[..., T, 3] -> float32[..., T * 3] / 255."""
    return tokens.reshape(*tokens.shape[:-2], -1).float() / 255.0


class PufferDefaultNet(nn.Module):
    """GELU encoder -> LSTM core -> action/value heads over ``obs_size`` =
    T * 3 inputs."""

    def __init__(self, num_actions: int, obs_size: int, hidden_size: int = 256, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.encoder = nn.Linear(obs_size, hidden_size, device=device)
        self.cell = nn.LSTMCell(hidden_size, hidden_size, device=device)
        self.action_head = nn.Linear(hidden_size, num_actions, device=device)
        self.value_head = nn.Linear(hidden_size, 1, device=device)
        if generator is not None:
            init_like_flax(self, generator)
            # std=0.01 action head, the reference's layer_init choice.
            with torch.no_grad():
                nn.init.normal_(self.action_head.weight, std=0.01, generator=generator)

    def initial_state(self, batch_shape: tuple[int, ...]) -> LSTMState:
        return zero_state(tuple(batch_shape), self.hidden_size, self.encoder.weight.device)

    def forward(self, tokens: torch.Tensor, state: LSTMState) -> tuple[torch.Tensor, torch.Tensor, LSTMState]:
        x = nn.functional.gelu(self.encoder(flatten_tokens(tokens)), approximate="tanh")
        new_state = lstm_step(self.cell, x, state)
        return self.action_head(new_state.h), self.value_head(new_state.h)[..., 0], new_state


class PufferDefaultPolicy(MultiAgentPolicy):
    """Batched recurrent policy with the PufferLib default architecture."""

    short_name = "puffer"

    def __init__(self, policy_env_info=None, num_actions: Optional[int] = None, hidden_size: int = 256,
                 seed: int = 0, device=None):
        super().__init__(policy_env_info)
        self._device = resolve_device(device)
        self._num_actions = num_actions_of(policy_env_info, num_actions)
        self._hidden_size = hidden_size
        self._init_gen, self._generator = generators(seed, self._device)
        self._net: Optional[PufferDefaultNet] = None
        self._state: Optional[LSTMState] = None

    def _build(self, obs_size: int, hidden_size: int, generator=None) -> PufferDefaultNet:
        self._net = PufferDefaultNet(self._num_actions, obs_size, hidden_size, device=self._device,
                                     generator=generator)
        return self._net

    def network(self) -> Optional[PufferDefaultNet]:
        return self._net

    def is_recurrent(self) -> bool:
        return True

    def reset(self) -> None:
        self._state = None

    def step_batch(self, raw_observations, raw_actions) -> None:
        tokens = as_tokens(raw_observations, self._device)
        if self._net is None:
            self._build(tokens.shape[-2] * 3, self._hidden_size, self._init_gen)
        if self._state is None:
            self._state = self._net.initial_state(tuple(tokens.shape[:-2]))
        with torch.no_grad():
            logits, _, self._state = self._net(tokens, self._state)
            write_actions(sample_actions(logits, self._generator), raw_actions)

    def save_policy_data(self, policy_data_path: str) -> None:
        save_tree(policy_data_path, params_to_flax(self._net))

    def load_policy_data(self, policy_data_path: str) -> None:
        tree = load_tree(policy_data_path)
        obs_size, hidden_size = tree["params"]["encoder"]["kernel"].shape
        params_from_flax(self._build(obs_size, hidden_size), tree)
