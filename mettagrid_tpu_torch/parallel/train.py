"""The learner on one device: one env step and an actor-critic (A2C)
update per call (reference: mettagrid_tpu/parallel/train.py).

The reference jits the env step and the update into one program and
carries the parameters and the optax state in its TrainState. Here the
parameters live in the policy module and the optimizer's state in a
``torch.optim`` optimizer, as PyTorch keeps them; TrainState carries the
env state, its observations, the LSTM state and the generator that draws
the actions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from mettagrid_tpu_torch.engine.state import EnvState
from mettagrid_tpu_torch.policy.lstm import LSTMPolicy, LSTMState
from mettagrid_tpu_torch.policy.policy import sample_actions


class TrainState(NamedTuple):
    env_state: EnvState
    obs: torch.Tensor  # uint8[E, A, T, 3]: observations of env_state
    lstm_state: LSTMState
    generator: torch.Generator  # draws the actions, on the policy's device


def trainable_parameters(policy: LSTMPolicy) -> list[nn.Parameter]:
    """Every parameter of ``policy`` but its LSTM cell's ``bias_ih``.

    flax's cell has one bias per gate where torch's has two, and
    policy/interop.py holds ``bias_ih`` at 0 and folds it into the flax bias
    on the way back. Both biases take the same gradient, so an optimizer
    that moved both would move the flax bias twice as far as optax does."""
    return [p for p in policy.parameters() if p is not policy.cell.bias_ih]


def adam(policy: LSTMPolicy, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)`` over ``trainable_parameters(policy)``: the same
    formula (ε outside the square root, no ε under it, both moments
    bias-corrected)."""
    return torch.optim.Adam(trainable_parameters(policy), lr, betas=(0.9, 0.999), eps=1e-8)


def a2c_loss(logits: torch.Tensor, values: torch.Tensor, actions: torch.Tensor, rewards: torch.Tensor,
             value_coef: float, entropy_coef: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, entropy) of one step: the policy gradient with the advantage
    ``rewards - values`` held constant, the squared value error and an
    entropy bonus, each a mean over agents. actions: int32[E, A]."""
    logp = torch.log_softmax(logits, dim=-1)
    taken = logp.gather(-1, actions.long()[..., None])[..., 0]
    adv = (rewards - values).detach()
    pg_loss = -(taken * adv).mean()
    v_loss = ((values - rewards) ** 2).mean()
    entropy = -(logp.exp() * logp).sum(dim=-1).mean()
    return pg_loss + value_coef * v_loss - entropy_coef * entropy, entropy


def make_train_step(
    program,
    step_fn: Callable,
    policy: LSTMPolicy,
    optimizer: torch.optim.Optimizer,
    *,
    value_coef: float = 0.5,
    entropy_coef: float = 0.01,
):
    """Returns train_step(ts, actions=None, mark=None) -> (ts, metrics):
    one env step and one A2C update, on the device of the policy and the
    env state.

    step_fn(state, actions, vibe_actions, obs_buf=...) -> (state,
    StepOutputs), as make_step's step: the trainer hands it ``ts.obs`` as
    the observation buffer to rewrite. ``optimizer`` is a torch.optim
    optimizer over ``trainable_parameters(policy)`` (``adam``); the LSTM
    cell's ``bias_ih`` is frozen here. ``actions`` (int32[E, A]) replaces
    the step's own draw from ``ts.generator``. The metrics ``loss``,
    ``entropy`` and ``reward_mean`` are 0-dim tensors on the device, read
    by the caller when it wants them: the step itself never waits for the
    device. Float matmuls must run without TF32, or the step raises.
    ``mark``, where given, is called with "forward", "env", "backward" and
    "optimizer" as each part of the step has been issued (the forward pass;
    the draw and the env step; the loss and its backward pass; the
    optimizer's update), for a caller that records CUDA events between
    them.
    """
    del program  # the reference's signature; the step needs nothing of it
    policy.cell.bias_ih.requires_grad_(False)

    def train_step(ts: TrainState, actions: torch.Tensor | None = None,
                   mark: Callable[[str], None] | None = None):
        note = mark or (lambda part: None)
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("the trainer's float matmuls must not round to TF32: "
                               "set torch.backends.cuda.matmul.allow_tf32 = False")
        # One forward pass, with grad, serves both the draw and the loss: the
        # reference applies the policy twice to the same inputs, once to draw
        # and once inside value_and_grad, which is the same function. It runs
        # before the env step, which rewrites ts.obs in place on the v2 and v3
        # observation routes.
        logits, values, new_lstm = policy(ts.obs, ts.lstm_state)
        note("forward")
        if actions is None:
            actions = sample_actions(logits.detach(), ts.generator)
        env_state, out = step_fn(ts.env_state, actions, torch.zeros_like(actions), obs_buf=ts.obs)
        note("env")
        loss, entropy = a2c_loss(logits, values, actions, out.rewards, value_coef, entropy_coef)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        note("backward")
        optimizer.step()
        note("optimizer")
        metrics = {"loss": loss.detach(), "entropy": entropy.detach(), "reward_mean": out.rewards.mean()}
        # Detached, so that no gradient crosses steps, as in the reference.
        lstm_state = LSTMState(h=new_lstm.h.detach(), c=new_lstm.c.detach())
        return TrainState(env_state, out.observations, lstm_state, ts.generator), metrics

    return train_step
