"""The learner: one env step and an actor-critic (A2C) update per call,
on one device or data-parallel over a mesh (reference:
mettagrid_tpu/parallel/train.py).

The reference jits the env step and the update into one program and
carries the parameters and the optax state in its TrainState. Here the
parameters live in the policy module and the optimizer's state in a
``torch.optim`` optimizer, as PyTorch keeps them; TrainState carries the
env state, its observations, the LSTM state and the generator that draws
the actions.

The reference shards the same function over its mesh: the loss is a mean
over every env, so XLA inserts the gradients' psum over "data". With a
mesh (parallel/mesh.py) each rank here steps its own rows of the envs,
takes the loss over its own agents, and averages the gradients over the
"data" ranks in one all-reduce of one flat buffer before the optimizer
steps. Equal shards make that mean the gradient of the global mean, and
each rank's own optimizer then takes the same step, so the parameters stay
replicated without a broadcast.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from mettagrid_tpu_torch.engine.state import EnvState
from mettagrid_tpu_torch.parallel.mesh import data_rows
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
    mesh: DeviceMesh | None = None,
):
    """Returns train_step(ts, actions=None, mark=None, perm=None,
    reset_maps=None) -> (ts, metrics): one env step and one A2C update, on
    the device of the policy and the env state.

    step_fn(state, actions, vibe_actions, obs_buf=...) -> (state,
    StepOutputs), as make_step's step: the trainer hands it ``ts.obs`` as
    the observation buffer to rewrite, and ``perm`` and ``reset_maps``,
    where given, as ``perm_in=`` and ``reset_maps=`` (the agent order of a
    step made with external_perm, and the maps of envs that auto-reset).
    ``optimizer`` is a torch.optim optimizer over
    ``trainable_parameters(policy)`` (``adam``); the LSTM cell's ``bias_ih``
    is frozen here. ``actions`` (int32[E, A]) replaces the step's own draw
    from ``ts.generator``. The metrics ``loss``, ``entropy`` and
    ``reward_mean`` are 0-dim tensors on the device, read by the caller when
    it wants them: the step itself never waits for the device. Float
    matmuls must run without TF32, or the step raises. ``mark``, where
    given, is called with "forward", "env", "backward" and "optimizer" as
    each part of the step has been issued (the forward pass; the draw and
    the env step; the loss and its backward pass; the optimizer's update),
    for a caller that records CUDA events between them.

    With ``mesh`` (parallel/mesh.py), ``ts`` holds this rank's rows of the
    envs (``shard_batch``) and the policy is replicated (``replicate``).
    ``actions``, ``perm`` and ``reset_maps`` are then the global batch's, as
    every rank holds them alike, and the rank takes its rows; its own draw
    takes its rows of one draw over the global batch, from a generator
    seeded alike on every rank, so that it equals the one-device draw. After
    the backward pass the gradients of ``trainable_parameters(policy)`` and
    the three metrics are averaged over the "data" ranks in one all-reduce
    of one flat buffer (``mark`` is called with "reduce" after it), so each
    rank reports the global metrics and steps its optimizer on the global
    mean's gradient.
    """
    del program  # the reference's signature; the step needs nothing of it
    policy.cell.bias_ih.requires_grad_(False)
    params = trainable_parameters(policy)
    if mesh is not None:
        group, n_data = mesh.get_group("data"), mesh.size(0)

    def rows(x: torch.Tensor, device: torch.device) -> torch.Tensor:
        """This rank's rows of a global-batch input (under a mesh)."""
        return x if mesh is None else x[data_rows(mesh, x.shape[0])].to(device)

    def all_reduce_mean(metrics: list[torch.Tensor]) -> list[torch.Tensor]:
        """Averages the gradients and ``metrics`` over the "data" ranks in
        one all-reduce; the gradients become views of the reduced buffer."""
        flat = torch.cat([p.grad.reshape(-1) for p in params] + [m.reshape(1) for m in metrics])
        dist.all_reduce(flat, group=group)
        flat /= n_data
        for p, g in zip(params, flat[:-len(metrics)].split([p.numel() for p in params])):
            p.grad = g.view_as(p)
        return list(flat[-len(metrics):].unbind())

    def train_step(ts: TrainState, actions: torch.Tensor | None = None,
                   mark: Callable[[str], None] | None = None, perm: torch.Tensor | None = None,
                   reset_maps: torch.Tensor | None = None):
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
            shard = None if mesh is None else (mesh.get_local_rank("data"), n_data)
            actions = sample_actions(logits.detach(), ts.generator, shard)
        else:
            actions = rows(actions, ts.obs.device)
        fed = {k: rows(v, ts.obs.device) for k, v in (("perm_in", perm), ("reset_maps", reset_maps)) if v is not None}
        env_state, out = step_fn(ts.env_state, actions, torch.zeros_like(actions), obs_buf=ts.obs, **fed)
        note("env")
        loss, entropy = a2c_loss(logits, values, actions, out.rewards, value_coef, entropy_coef)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        note("backward")
        metrics = [loss.detach(), entropy.detach(), out.rewards.mean()]
        if mesh is not None:
            metrics = all_reduce_mean(metrics)
            note("reduce")
        optimizer.step()
        note("optimizer")
        # Detached, so that no gradient crosses steps, as in the reference.
        lstm_state = LSTMState(h=new_lstm.h.detach(), c=new_lstm.c.detach())
        return (TrainState(env_state, out.observations, lstm_state, ts.generator),
                dict(zip(("loss", "entropy", "reward_mean"), metrics)))

    return train_step
