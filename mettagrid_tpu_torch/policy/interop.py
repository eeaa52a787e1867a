"""Parameters across the two packages: flax trees in, flax trees out, and
flax's initialisers drawn from a torch.Generator.

The JAX package's policies keep their parameters as the tree that
``flax_module.init`` returns and pickle it as nested dicts of numpy arrays
(``jax.device_get(params)``); that file is the policy data format of both
packages. The mapping, per layer:

- ``Dense`` kernel ``[in, out]`` -> ``Linear.weight`` ``[out, in]``; bias as is;
- ``Embed.embedding`` -> ``Embedding.weight`` as is;
- ``LayerNorm`` ``scale``, ``bias`` -> ``weight``, ``bias``;
- the LSTM cell's input kernels ``ii, if, ig, io`` (no bias) and hidden
  kernels ``hi, hf, hg, ho`` (with bias) -> ``weight_ih = cat(ii, if, ig,
  io)ᵀ``, ``weight_hh = cat(hi, hf, hg, ho)ᵀ``, ``bias_hh = cat(b_hi, b_hf,
  b_hg, b_ho)`` and ``bias_ih = 0``, in torch's gate order i, f, g, o. On
  the way back ``bias_ih`` is folded into the hidden biases, which is the
  same function.

A submodule takes its flax name unless its class lists another in
``FLAX_NAMES`` (flax name -> attribute); a net whose tree has another shape
(policy/torch_compat.py) converts it in its own ``state_dict_from_flax``.

Adam's state crosses the same way (``opt_state_from_optax``,
``opt_state_to_optax``): optax's ``(ScaleByAdamState(count, mu, nu),
EmptyState())`` holds ``mu`` and ``nu`` as trees shaped like the
parameters, which map per layer as above onto torch Adam's per-parameter
``exp_avg`` and ``exp_avg_sq``, and ``count`` onto each one's ``step``.
``bias_ih`` has no state: it does not train (parallel/train.py).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch import nn

GATES = ("i", "f", "g", "o")  # torch's gate order


def _t(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32), device=like.device)


def _convert(module: nn.Module, tree: dict, prefix: str, out: dict) -> None:
    names = getattr(module, "FLAX_NAMES", {})
    for flax_name, sub in tree.items():
        child = getattr(module, names.get(flax_name, flax_name))
        p = prefix + names.get(flax_name, flax_name) + "."
        if isinstance(child, nn.Embedding):
            out[p + "weight"] = _t(sub["embedding"], child.weight)
        elif isinstance(child, nn.Linear):
            out[p + "weight"] = _t(sub["kernel"], child.weight).T
            if "bias" in sub:
                out[p + "bias"] = _t(sub["bias"], child.weight)
        elif isinstance(child, nn.LayerNorm):
            out[p + "weight"] = _t(sub["scale"], child.weight)
            out[p + "bias"] = _t(sub["bias"], child.weight)
        elif isinstance(child, nn.LSTMCell):
            w = child.weight_ih
            out[p + "weight_ih"] = torch.cat([_t(sub["i" + g]["kernel"], w) for g in GATES], dim=1).T
            out[p + "weight_hh"] = torch.cat([_t(sub["h" + g]["kernel"], w) for g in GATES], dim=1).T
            out[p + "bias_hh"] = torch.cat([_t(sub["h" + g]["bias"], w) for g in GATES])
            out[p + "bias_ih"] = torch.zeros_like(child.bias_ih)
        else:
            _convert(child, sub, p, out)


def _state_dict(net: nn.Module, tree: dict) -> dict[str, torch.Tensor]:
    """``net``'s state dict read from a tree shaped like its flax parameters."""
    tree = tree.get("params", tree)
    if hasattr(net, "state_dict_from_flax"):
        return net.state_dict_from_flax(tree)
    state: dict[str, torch.Tensor] = {}
    _convert(net, tree, "", state)
    return state


def params_from_flax(net: nn.Module, tree: dict) -> nn.Module:
    """Load a flax parameter tree (``{"params": {...}}`` or its inside, as
    nested dicts of numpy arrays) into ``net``; every parameter must be
    covered. Returns ``net``."""
    with torch.no_grad():
        net.load_state_dict(_state_dict(net, tree), strict=True)
    return net


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).numpy().copy()


def _to_flax(module: nn.Module, value: Callable[[torch.Tensor], torch.Tensor]) -> dict:
    """The flax tree of ``value(p)`` for each parameter ``p`` of ``module``."""
    inverse = {v: k for k, v in getattr(module, "FLAX_NAMES", {}).items()}
    tree: dict[str, Any] = {}
    for name, child in module.named_children():
        key = inverse.get(name, name)
        if isinstance(child, nn.Embedding):
            tree[key] = {"embedding": _numpy(value(child.weight))}
        elif isinstance(child, nn.Linear):
            tree[key] = {"kernel": _numpy(value(child.weight).T)}
            if child.bias is not None:
                tree[key]["bias"] = _numpy(value(child.bias))
        elif isinstance(child, nn.LayerNorm):
            tree[key] = {"scale": _numpy(value(child.weight)), "bias": _numpy(value(child.bias))}
        elif isinstance(child, nn.LSTMCell):
            w_ih, w_hh = value(child.weight_ih).chunk(4), value(child.weight_hh).chunk(4)
            b = (value(child.bias_ih) + value(child.bias_hh)).chunk(4)
            tree[key] = {}
            for g, wi, wh, bh in zip(GATES, w_ih, w_hh, b):
                tree[key]["i" + g] = {"kernel": _numpy(wi.T)}
                tree[key]["h" + g] = {"kernel": _numpy(wh.T), "bias": _numpy(bh)}
        elif any(True for _ in child.parameters()):
            tree[key] = _to_flax(child, value)
    return tree


def params_to_flax(net: nn.Module) -> dict:
    """The flax parameter tree of ``net``, ``{"params": {...}}`` as nested
    dicts of numpy arrays: what the JAX package's policies pickle."""
    return {"params": _to_flax(net, lambda p: p)}


class ScaleByAdamState(NamedTuple):
    """optax's Adam state, field for field: ``count`` int32, ``mu`` and
    ``nu`` trees shaped like the flax parameters."""

    count: np.ndarray
    mu: dict
    nu: dict


class EmptyState(NamedTuple):
    """optax's state of a transformation that keeps none (the learning-rate
    scale in ``optax.adam``)."""


def _adam_params(optimizer: torch.optim.Optimizer, net: nn.Module) -> dict[int, str]:
    """{id(parameter): name} of ``net``'s parameters that ``optimizer``
    trains; refuses an LSTM cell's ``bias_ih``, whose moments flax has no
    place for."""
    names = {id(p): n for n, p in net.named_parameters()}
    trained = {id(p) for group in optimizer.param_groups for p in group["params"]}
    for module in net.modules():
        if isinstance(module, nn.LSTMCell) and id(module.bias_ih) in trained:
            raise ValueError("the optimizer trains an LSTM cell's bias_ih, which flax's cell does not have")
    missing = trained - names.keys()
    if missing:
        raise ValueError(f"the optimizer trains {len(missing)} tensors that are not parameters of the net")
    return {i: names[i] for i in trained}


def opt_state_from_optax(optimizer: torch.optim.Optimizer, net: nn.Module, state) -> torch.optim.Optimizer:
    """Load optax's Adam state ``(ScaleByAdamState(count, mu, nu),
    EmptyState())`` (as ``optax.adam(...).init`` or ``update`` returns it,
    or ``opt_state_to_optax``) into ``optimizer``, a ``torch.optim.Adam``
    over parameters of ``net``. Returns ``optimizer``."""
    adam = state[0]
    trained = _adam_params(optimizer, net)
    mu, nu = _state_dict(net, adam.mu), _state_dict(net, adam.nu)
    count = float(np.asarray(adam.count))
    for group in optimizer.param_groups:
        on_device = group.get("capturable", False) or group.get("fused", False)
        for p in group["params"]:
            name = trained[id(p)]
            optimizer.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32, device=p.device if on_device else "cpu"),
                "exp_avg": mu[name].to(p.device).clone(),
                "exp_avg_sq": nu[name].to(p.device).clone(),
            }
    return optimizer


def opt_state_to_optax(optimizer: torch.optim.Optimizer, net: nn.Module) -> tuple[ScaleByAdamState, EmptyState]:
    """``optimizer``'s Adam state (a ``torch.optim.Adam`` over parameters of
    ``net``) as optax's ``(ScaleByAdamState(count, mu, nu), EmptyState())``
    with numpy leaves; a parameter without state (untrained, or not in the
    optimizer) has zero moments."""
    _adam_params(optimizer, net)
    states = [s for s in optimizer.state.values() if "step" in s]
    count = np.int32(max((int(s["step"]) for s in states), default=0))

    def moment(key):
        def value(p):
            s = optimizer.state.get(p)
            return s[key] if s else torch.zeros_like(p)

        return {"params": _to_flax(net, value)}

    return ScaleByAdamState(count=count, mu=moment("exp_avg"), nu=moment("exp_avg_sq")), EmptyState()


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # flax's lecun_normal: a normal truncated at two deviations, scaled so
    # that the variance is 1 / fan_in.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_like_flax(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``net``'s parameters as flax's default initialisers do, from
    ``generator``: Dense kernels lecun-normal and biases 0, Embed normal with
    variance 1 / num_embeddings, LayerNorm 1 and 0, LSTM input kernels
    lecun-normal and hidden kernels orthogonal per gate, biases 0."""
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, nn.Linear):
                _lecun_normal_(module.weight, module.in_features, generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                nn.init.normal_(module.weight, std=1.0 / math.sqrt(module.num_embeddings), generator=generator)
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, (nn.LSTMCell, nn.LSTM)):
                for name, p in module.named_parameters():
                    if name.startswith("weight_ih"):
                        for gate in p.chunk(4):
                            _lecun_normal_(gate, p.shape[1], generator)
                    elif name.startswith("weight_hh"):
                        for gate in p.chunk(4):
                            nn.init.orthogonal_(gate, generator=generator)
                    else:
                        p.zero_()
    return net
