"""Policy framework: per-agent and batched policies, registry, specs
(reference: mettagrid_tpu/policy/policy.py).

Two levels:
  - AgentPolicy: one agent, decoded AgentObservation in, action name/id out.
  - MultiAgentPolicy: the batch interface — step_batch(raw_obs, raw_actions)
    fills the action buffer in place from the raw token observations.
Device-native policies (LSTMPolicy in policy/lstm.py) plug in through
TorchMultiAgentPolicy, which keeps the net and its state on its device.

The nets' policies (``lstm``, ``puffer``, ``stateless``) take ``device=None``,
which means CUDA and raises without a card unless the caller passes
``device="cpu"``; the random and noop policies are numpy and take none.
Their policy data files are the JAX package's: a pickled flax parameter
tree of numpy arrays (policy/interop.py).
"""

from __future__ import annotations

import inspect
import pickle
from typing import Any, Dict, Generic, Optional, Tuple, TypeVar

import numpy as np
import torch
from pydantic import BaseModel, Field

from mettagrid_tpu_torch.engine.state import resolve_device
from mettagrid_tpu_torch.policy.interop import params_from_flax, params_to_flax
from mettagrid_tpu_torch.policy.lstm import LSTMPolicy
from mettagrid_tpu_torch.simulator.interface import AgentObservation
from mettagrid_tpu_torch.util.module import load_symbol

# ---------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------

POLICY_REGISTRY: Dict[str, type] = {}


class PolicyRegistryMeta(type):
    """Auto-registers MultiAgentPolicy subclasses by short_name(s)
    (reference: policy/policy_registry.py)."""

    def __new__(mcs, name, bases, ns):
        cls = super().__new__(mcs, name, bases, ns)
        names = ns.get("short_names") or []
        single = ns.get("short_name")
        if single:
            names = [single, *names]
        for short in names:
            existing = POLICY_REGISTRY.get(short)
            if existing is not None and existing is not cls:
                raise ValueError(
                    f"Policy short name {short!r} already registered to {existing.__qualname__}"
                )
            POLICY_REGISTRY[short] = cls
        return cls


class PolicySpec(BaseModel):
    """URI-addressable policy description (reference: policy/policy.py:386-396)."""

    class_path: str = Field(description="Dotted path or registry short name")
    policy_data_path: Optional[str] = Field(default=None)
    init_kwargs: dict[str, Any] = Field(default_factory=dict)

    def resolve_class(self) -> type:
        if self.class_path in POLICY_REGISTRY:
            return POLICY_REGISTRY[self.class_path]
        return load_symbol(self.class_path)


# ---------------------------------------------------------------------
# per-agent policies
# ---------------------------------------------------------------------


class AgentPolicy:
    """Base class for per-agent policies (reference: policy.py:26-84)."""

    def __init__(self, policy_env_info=None):
        self._env_info = policy_env_info

    def step(self, obs: AgentObservation):
        raise NotImplementedError

    def step_group(self, observations: list[tuple[int, AgentObservation]]):
        return [self.step(obs) for _, obs in observations]

    def reset(self, simulation=None) -> None:
        pass


StateType = TypeVar("StateType")


class StatefulPolicyImpl(Generic[StateType]):
    """Stateful policy core: (obs, state) -> (action, state)
    (reference: policy.py:348-381)."""

    def initial_state(self) -> StateType:
        raise NotImplementedError

    def step_with_state(self, obs: AgentObservation, state: StateType) -> Tuple[Any, StateType]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class StatefulAgentPolicy(AgentPolicy, Generic[StateType]):
    """Wraps a StatefulPolicyImpl, carrying the state between steps
    (reference: policy.py:283-344)."""

    def __init__(self, impl: StatefulPolicyImpl[StateType], policy_env_info=None):
        super().__init__(policy_env_info)
        self._impl = impl
        self._state: Optional[StateType] = None

    def step(self, obs: AgentObservation):
        if self._state is None:
            self._state = self._impl.initial_state()
        action, self._state = self._impl.step_with_state(obs, self._state)
        return action

    def reset(self, simulation=None) -> None:
        self._state = None
        self._impl.reset()


# ---------------------------------------------------------------------
# batched policies
# ---------------------------------------------------------------------


class MultiAgentPolicy(metaclass=PolicyRegistryMeta):
    """Batched policy over raw token observations
    (reference: policy.py:86-160)."""

    short_name: Optional[str] = None

    def __init__(self, policy_env_info=None, **kwargs):
        self._env_info = policy_env_info

    def agent_policy(self, agent_id: int) -> AgentPolicy:
        """A per-agent view driving this batched policy."""
        return _BatchedAgentView(self, agent_id)

    def load_policy_data(self, policy_data_path: str) -> None:
        pass

    def save_policy_data(self, policy_data_path: str) -> None:
        pass

    def reset(self) -> None:
        pass

    def step_batch(self, raw_observations: np.ndarray, raw_actions: np.ndarray) -> None:
        """raw_observations: uint8[n_agents, T, 3]; write int32 action ids
        into raw_actions[n_agents] in place."""
        raise NotImplementedError


class _BatchedAgentView(AgentPolicy):
    def __init__(self, policy: MultiAgentPolicy, agent_id: int):
        super().__init__()
        self._policy = policy
        self._agent_id = agent_id

    def step(self, obs: AgentObservation):
        raise NotImplementedError("batched policies step through step_batch")


class RandomMultiAgentPolicy(MultiAgentPolicy):
    """Uniform random actions (reference: policy/random_agent.py)."""

    short_name = "random"

    def __init__(self, policy_env_info=None, num_actions: Optional[int] = None, seed: int = 0):
        super().__init__(policy_env_info)
        self._num_actions = num_actions_of(policy_env_info, num_actions)
        self._rng = np.random.default_rng(seed)

    def step_batch(self, raw_observations: np.ndarray, raw_actions: np.ndarray) -> None:
        raw_actions[:] = self._rng.integers(0, self._num_actions, size=raw_actions.shape)


class NoopMultiAgentPolicy(MultiAgentPolicy):
    """Always noop (reference: policy/noop.py)."""

    short_name = "noop"

    def step_batch(self, raw_observations: np.ndarray, raw_actions: np.ndarray) -> None:
        raw_actions[:] = 0


def num_actions_of(policy_env_info, num_actions: Optional[int] = None) -> int:
    if num_actions is not None:
        return num_actions
    return len(policy_env_info.action_names) if policy_env_info else 1


def as_tokens(raw_observations, device: torch.device) -> torch.Tensor:
    """The observations as a uint8 tensor on ``device``: a tensor already
    there is taken without a copy, a numpy array is copied there."""
    return torch.as_tensor(raw_observations, dtype=torch.uint8, device=device)


def sample_actions(logits: torch.Tensor, generator: torch.Generator,
                   shard: tuple[int, int] | None = None) -> torch.Tensor:
    """One categorical draw per row of logits (the Gumbel-max trick:
    argmax(logits - log E) with E ~ Exp(1)), as int32. With ``shard`` =
    (index, count) the logits are part ``index`` of ``count`` equal parts of
    a batch along the first axis: the noise is drawn for the whole batch and
    this part of it taken, so that the draws equal that batch's draw."""
    if shard is None:
        noise = torch.empty_like(logits).exponential_(generator=generator)
    else:
        index, count = shard
        E = logits.shape[0]
        noise = logits.new_empty((count * E,) + logits.shape[1:]).exponential_(generator=generator)
        noise = noise[index * E:(index + 1) * E]
    return (logits - noise.log()).argmax(dim=-1).to(torch.int32)


def write_actions(actions: torch.Tensor, raw_actions) -> None:
    """Write int32 actions into ``raw_actions`` in place: a tensor (on any
    device) or a numpy array, which waits for the device."""
    if isinstance(raw_actions, torch.Tensor):
        raw_actions.copy_(actions.reshape(raw_actions.shape))
    else:
        raw_actions[...] = actions.cpu().numpy().reshape(raw_actions.shape)


def load_tree(policy_data_path: str) -> dict:
    """A policy data file: the pickled flax parameter tree (a pickle, so
    load only files from a trusted source)."""
    with open(policy_data_path, "rb") as f:
        return pickle.load(f)


def save_tree(policy_data_path: str, tree: dict) -> None:
    with open(policy_data_path, "wb") as f:
        pickle.dump(tree, f)


def generators(seed: int, device: torch.device) -> tuple[torch.Generator, torch.Generator]:
    """A policy's own generators on its device: one for its parameters
    (seeded ``seed``) and one for its actions (``seed + 1``)."""
    init, sample = torch.Generator(device=device), torch.Generator(device=device)
    init.manual_seed(seed)
    sample.manual_seed(seed + 1)
    return init, sample


class TorchMultiAgentPolicy(MultiAgentPolicy):
    """Device-resident LSTMPolicy behind the buffer protocol: the whole
    agent batch forwards in one call and the recurrent state stays on the
    policy's device. ``params`` is a flax parameter tree to start from;
    without one the parameters are drawn from the policy's generator."""

    short_name = "lstm"

    def __init__(self, policy_env_info=None, policy=None, params=None, seed: int = 0, device=None):
        super().__init__(policy_env_info)
        self._device = resolve_device(device)
        init_gen, self._generator = generators(seed, self._device)
        if policy is None:
            policy = LSTMPolicy(num_actions=num_actions_of(policy_env_info), device=self._device, generator=init_gen)
        self._policy = policy
        if params is not None:
            params_from_flax(self._policy, params)
        self._lstm_state = None

    def network(self) -> LSTMPolicy:
        return self._policy

    def reset(self) -> None:
        self._lstm_state = None

    def step_batch(self, raw_observations, raw_actions) -> None:
        """raw_observations: uint8[..., T, 3] (a tensor, taken on the
        policy's device without a copy, or numpy); the int32 actions are
        written into raw_actions[...] in place."""
        tokens = as_tokens(raw_observations, self._device)
        if self._lstm_state is None:
            self._lstm_state = self._policy.initial_state(tuple(tokens.shape[:-2]))
        with torch.no_grad():
            logits, _, self._lstm_state = self._policy(tokens, self._lstm_state)
            write_actions(sample_actions(logits, self._generator), raw_actions)

    def save_policy_data(self, policy_data_path: str) -> None:
        save_tree(policy_data_path, params_to_flax(self._policy))

    def load_policy_data(self, policy_data_path: str) -> None:
        params_from_flax(self._policy, load_tree(policy_data_path))


def load_policy(spec: PolicySpec, policy_env_info=None, device=None) -> MultiAgentPolicy:
    """Instantiate + load a policy from a spec (reference: policy/loader.py).
    ``device`` goes to a policy class that takes one, unless the spec's
    init_kwargs name it."""
    cls = spec.resolve_class()
    kwargs = dict(spec.init_kwargs)
    if device is not None and "device" in inspect.signature(cls).parameters:
        kwargs.setdefault("device", device)
    policy = cls(policy_env_info, **kwargs)
    if spec.policy_data_path:
        policy.load_policy_data(spec.policy_data_path)
    return policy
