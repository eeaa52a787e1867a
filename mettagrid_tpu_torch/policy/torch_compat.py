"""The reference's torch LSTM policy, native: its checkpoints load as they are
(reference: mettagrid_tpu/policy/torch_compat.py).

The reference's ``LSTMPolicy`` is a torch net (flatten(obs)/255 ->
Linear(128) -> ReLU -> Linear(128) -> LSTM(128) -> action/value heads)
checkpointed as a torch state dict. ``TorchRefLSTMNet`` has the same module
tree, so its ``state_dict`` has the checkpoint's own keys (``_net.0``,
``_net.2``, ``_rnn.*_l0``, ``_action_head``, ``_value_head``) and a
checkpoint loads with ``load_state_dict``.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from mettagrid_tpu_torch.engine.state import resolve_device
from mettagrid_tpu_torch.policy.interop import init_like_flax
from mettagrid_tpu_torch.policy.policy import as_tokens, sample_actions, write_actions


class TorchLSTMState(NamedTuple):
    h: torch.Tensor  # [..., hidden]
    c: torch.Tensor


class TorchRefLSTMNet(nn.Module):
    """The reference LSTMPolicyNet's module tree (policy/lstm.py:24-43)."""

    def __init__(self, num_actions: int, obs_size: int, hidden_size: int = 128, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        h = hidden_size
        self.hidden_size = hidden_size
        self._net = nn.Sequential(nn.Linear(obs_size, h, device=device), nn.ReLU(), nn.Linear(h, h, device=device))
        self._rnn = nn.LSTM(h, h, batch_first=True, device=device)
        self._action_head = nn.Linear(h, num_actions, device=device)
        self._value_head = nn.Linear(h, 1, device=device)
        if generator is not None:
            init_like_flax(self, generator)

    def forward(self, obs_flat: torch.Tensor, state: TorchLSTMState):
        """obs_flat: f32[B, obs_size] already /255-normalized; state [B, hidden]."""
        x = self._net(obs_flat)
        out, (h, c) = self._rnn(x[:, None], (state.h[None], state.c[None]))
        y = out[:, 0]
        return self._action_head(y), self._value_head(y)[..., 0], TorchLSTMState(h=h[0], c=c[0])

    def state_dict_from_flax(self, tree: Mapping) -> dict[str, torch.Tensor]:
        """The state dict of the JAX package's flax twin's tree (``net0``,
        ``net2``, ``ih`` with the two LSTM biases summed, ``hh``; used by
        policy/interop.params_from_flax)."""
        dev = self._action_head.weight.device

        def t(x):
            return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)

        out = {}
        for flax_name, key in (("net0", "_net.0"), ("net2", "_net.2"), ("action_head", "_action_head"),
                               ("value_head", "_value_head")):
            out[f"{key}.weight"] = t(tree[flax_name]["kernel"]).T
            out[f"{key}.bias"] = t(tree[flax_name]["bias"])
        out["_rnn.weight_ih_l0"] = t(tree["ih"]["kernel"]).T
        out["_rnn.weight_hh_l0"] = t(tree["hh"]["kernel"]).T
        out["_rnn.bias_ih_l0"] = t(tree["ih"]["bias"])
        out["_rnn.bias_hh_l0"] = torch.zeros_like(out["_rnn.bias_ih_l0"])
        return out


def load_torch_lstm_checkpoint(path: str, num_actions: int, obs_size: int, hidden_size: int = 128,
                               device=None) -> TorchRefLSTMNet:
    """A reference torch checkpoint loaded into the native net on ``device``."""
    net = TorchRefLSTMNet(num_actions=num_actions, obs_size=obs_size, hidden_size=hidden_size, device=device)
    net.load_state_dict(torch.load(path, map_location=net._action_head.weight.device))
    return net


class TorchCompatLSTMPolicy:
    """MultiAgentPolicy-compatible wrapper around a reference checkpoint (a
    file, or its ``state_dict``): keeps per-agent recurrent state, argmax or
    sampled actions over the reference's own logits. ``device=None`` means
    CUDA and raises without a card unless the caller passes ``device="cpu"``."""

    short_names = ["torch_lstm"]

    def __init__(self, num_actions: int, obs_size: int, checkpoint_path: Optional[str] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, hidden_size: int = 128,
                 deterministic: bool = True, seed: int = 0, device=None):
        if checkpoint_path is None and state_dict is None:
            raise ValueError("TorchCompatLSTMPolicy needs checkpoint_path or state_dict")
        self._device = resolve_device(device)
        if checkpoint_path is not None:
            self._net = load_torch_lstm_checkpoint(checkpoint_path, num_actions, obs_size, hidden_size, self._device)
        else:
            self._net = TorchRefLSTMNet(num_actions, obs_size, hidden_size, device=self._device)
            self._net.load_state_dict(state_dict)
        self._hidden = hidden_size
        self._deterministic = deterministic
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(seed)
        self._state: Optional[TorchLSTMState] = None

    def reset(self) -> None:
        self._state = None

    def step_batch(self, raw_observations, raw_actions) -> None:
        obs = as_tokens(raw_observations, self._device)
        obs = obs.reshape(obs.shape[0], -1).float() / 255.0
        if self._state is None:
            z = torch.zeros((obs.shape[0], self._hidden), device=self._device)
            self._state = TorchLSTMState(h=z, c=z)
        with torch.no_grad():
            logits, _value, self._state = self._net(obs, self._state)
            acts = logits.argmax(dim=-1) if self._deterministic else sample_actions(logits, self._generator)
            write_actions(acts.to(torch.int32), raw_actions)
