"""LSTM policy: TokenEncoder -> Dense -> LSTM cell -> action/value heads
(reference: mettagrid_tpu/policy/lstm.py).

The state is an explicit (h, c) pair carried by the caller; a BPTT unroll is
a loop over the time axis. The cell is torch's ``LSTMCell``, whose gate
math equals flax's ``OptimizedLSTMCell`` (policy/interop.py maps the
parameters).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from mettagrid_tpu_torch.policy.interop import init_like_flax
from mettagrid_tpu_torch.policy.token_encoder import TokenEncoder


class LSTMState(NamedTuple):
    h: torch.Tensor  # f32[..., hidden]
    c: torch.Tensor  # f32[..., hidden]


def zero_state(batch_shape: tuple[int, ...], hidden_size: int, device) -> LSTMState:
    shape = (*batch_shape, hidden_size)
    return LSTMState(h=torch.zeros(shape, device=device), c=torch.zeros(shape, device=device))


def lstm_step(cell: nn.LSTMCell, x: torch.Tensor, state: LSTMState) -> LSTMState:
    """One cell step over any batch shape: x [..., in], state [..., hidden]."""
    batch, hidden = x.shape[:-1], state.h.shape[-1]
    h, c = cell(x.reshape(-1, x.shape[-1]), (state.h.reshape(-1, hidden), state.c.reshape(-1, hidden)))
    return LSTMState(h=h.reshape(*batch, hidden), c=c.reshape(*batch, hidden))


class LSTMPolicy(nn.Module):
    """Recurrent actor-critic over token observations. Parameters are drawn
    from ``generator`` (flax's initialisers) when one is given."""

    def __init__(self, num_actions: int, hidden_size: int = 128, encoder_hidden: int = 192,
                 feature_norms: tuple[float, ...] = (), device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.num_actions = num_actions
        self.hidden_size = hidden_size
        self.encoder = TokenEncoder(hidden_size=encoder_hidden, feature_norms=feature_norms, device=device)
        self.pre = nn.Linear(encoder_hidden, hidden_size, device=device)
        self.cell = nn.LSTMCell(hidden_size, hidden_size, device=device)
        self.action_head = nn.Linear(hidden_size, num_actions, device=device)
        self.value_head = nn.Linear(hidden_size, 1, device=device)
        if generator is not None:
            init_like_flax(self, generator)

    def initial_state(self, batch_shape: tuple[int, ...]) -> LSTMState:
        return zero_state(tuple(batch_shape), self.hidden_size, self.pre.weight.device)

    def forward(self, tokens: torch.Tensor, state: LSTMState) -> tuple[torch.Tensor, torch.Tensor, LSTMState]:
        """One step. tokens: uint8[..., T, 3]; state: (h, c)[..., hidden].

        Returns (logits[..., n_actions], value[...], new_state)."""
        x = torch.relu(self.pre(self.encoder(tokens)))
        new_state = lstm_step(self.cell, x, state)
        return self.action_head(new_state.h), self.value_head(new_state.h)[..., 0], new_state


def unroll(policy: LSTMPolicy, tokens: torch.Tensor, state: LSTMState) -> tuple[torch.Tensor, torch.Tensor, LSTMState]:
    """BPTT unroll. tokens: uint8[T_time, ..., T_tok, 3] (time leading).

    Returns (logits[T_time, ..., n_actions], values[T_time, ...], final state)."""
    logits, values = [], []
    for tok_t in tokens:
        step_logits, step_value, state = policy(tok_t, state)
        logits.append(step_logits)
        values.append(step_value)
    return torch.stack(logits), torch.stack(values), state


def init_policy(policy: LSTMPolicy, generator: torch.Generator, example_tokens: torch.Tensor
                ) -> tuple[dict[str, torch.Tensor], LSTMState]:
    """Draw the policy's parameters from ``generator``; returns them with the
    zero state for a batch shaped like ``example_tokens[:-2]``."""
    init_like_flax(policy, generator)
    return policy.state_dict(), policy.initial_state(tuple(example_tokens.shape[:-2]))
