"""Adam's state across the packages, on the CPU: optax's
``(ScaleByAdamState(count, mu, nu), EmptyState())`` and torch Adam's
per-parameter state through ``policy/interop.opt_state_from_optax`` and
``opt_state_to_optax``.

An LSTMPolicy (widths 32) starts from one flax init on both sides, and
five seeded gradient trees drive ``optax.adam(1e-3)`` and the port's
``parallel.adam``: the two runs, and runs that switch package after two
updates (the optimizer state and the parameters converted across), agree
within 1e-6 after every update. The conversion round-trips exactly, and
refuses an optimizer that trains the LSTM cell's ``bias_ih``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mettagrid_tpu.policy import lstm as jlstm
from mettagrid_tpu_torch.parallel import adam
from mettagrid_tpu_torch.policy import (
    LSTMPolicy,
    opt_state_from_optax,
    opt_state_to_optax,
    params_from_flax,
    params_to_flax,
)
from mettagrid_tpu_torch.policy.interop import _state_dict

N_ACTIONS, H, T, LR, STEPS, SWITCH = 5, 32, 12, 1e-3, 5, 2
TOL = dict(atol=1e-6, rtol=0)


def _params():
    net = jlstm.LSTMPolicy(num_actions=N_ACTIONS, hidden_size=H, encoder_hidden=H)
    tokens = jnp.zeros((1, T, 3), jnp.uint8)
    return jax.device_get(net.init(jax.random.PRNGKey(0), tokens, net.initial_state((1,))))


def _grads(params):
    """STEPS gradient trees shaped like params, seeded: magnitudes over four
    decades, and whole rows at 0 (an embedding row no token reached)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        def leaf(p):
            g = (rng.standard_normal(p.shape) * 10.0 ** rng.uniform(-4, 0, p.shape)).astype(np.float32)
            if g.ndim == 2:
                g[rng.random(g.shape[0]) < 0.2] = 0.0
            return g

        out.append(jax.tree_util.tree_map(leaf, params))
    return out


def _port(params):
    policy = params_from_flax(LSTMPolicy(N_ACTIONS, H, H, device="cpu"), params)
    return policy, adam(policy, LR)


def _torch_update(policy, optimizer, grad_tree):
    grads = _state_dict(policy, grad_tree)
    for name, p in policy.named_parameters():
        p.grad = grads[name].clone()
    optimizer.step()


def _optax_update(opt, params, state, grad_tree):
    updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, grad_tree), state, params)
    return jax.device_get(optax.apply_updates(params, updates)), state


def _close(port_tree, ref_tree, where):
    for (path, got), (_, want) in zip(jax.tree_util.tree_leaves_with_path(port_tree),
                                      jax.tree_util.tree_leaves_with_path(ref_tree)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=f"{where}{jax.tree_util.keystr(path)}",
                                   **TOL)


def _optax_run(params, grads):
    opt = optax.adam(LR)
    state = opt.init(params)
    trail = []
    for g in grads:
        params, state = _optax_update(opt, params, state, g)
        trail.append(params)
    return trail


def test_five_updates_match_and_continue_across():
    params = _params()
    grads = _grads(params)
    ref = _optax_run(params, grads)

    # The port alone.
    policy, optimizer = _port(params)
    for i, g in enumerate(grads):
        _torch_update(policy, optimizer, g)
        _close(params_to_flax(policy), ref[i], f"torch step {i}: ")

    # optax for SWITCH updates, then the port from optax's state.
    opt = optax.adam(LR)
    p, state = params, opt.init(params)
    for g in grads[:SWITCH]:
        p, state = _optax_update(opt, p, state, g)
    policy, optimizer = _port(p)
    opt_state_from_optax(optimizer, policy, jax.device_get(state))
    for i, g in enumerate(grads[SWITCH:], SWITCH):
        _torch_update(policy, optimizer, g)
        _close(params_to_flax(policy), ref[i], f"optax then torch, step {i}: ")

    # The port for SWITCH updates, then optax from the port's state.
    policy, optimizer = _port(params)
    for g in grads[:SWITCH]:
        _torch_update(policy, optimizer, g)
    p, state = params_to_flax(policy), opt_state_to_optax(optimizer, policy)
    assert int(state[0].count) == SWITCH
    for i, g in enumerate(grads[SWITCH:], SWITCH):
        p, state = _optax_update(opt, p, state, g)
        _close(p, ref[i], f"torch then optax, step {i}: ")


def test_state_round_trips():
    params = _params()
    grads = _grads(params)
    opt = optax.adam(LR)
    p, state = params, opt.init(params)
    for g in grads[:3]:
        p, state = _optax_update(opt, p, state, g)
    state = jax.device_get(state)
    policy, optimizer = _port(p)
    opt_state_from_optax(optimizer, policy, state)
    back = opt_state_to_optax(optimizer, policy)
    assert int(back[0].count) == int(state[0].count) == 3
    for name in ("mu", "nu"):
        _close(getattr(back[0], name), getattr(state[0], name), f"{name}: ")
    assert back[0].mu.keys() == state[0].mu.keys() == {"params"}
    for tensor in optimizer.state.values():
        assert float(tensor["step"]) == 3.0
    assert policy.cell.bias_ih not in optimizer.state


def test_refuses_a_trained_bias_ih():
    params = _params()
    policy = params_from_flax(LSTMPolicy(N_ACTIONS, H, H, device="cpu"), params)
    optimizer = torch.optim.Adam(policy.parameters(), LR)
    state = optax.adam(LR).init(params)
    with pytest.raises(ValueError, match="bias_ih"):
        opt_state_from_optax(optimizer, policy, state)
    with pytest.raises(ValueError, match="bias_ih"):
        opt_state_to_optax(optimizer, policy)
