"""The port's policy nets against their flax originals, on the CPU.

Each net starts from a flax init, is carried into the port by
``policy/interop.params_from_flax``, and both forward the same tokens (made
with a seeded numpy generator, EMPTY tokens among them) from the same
state: logits, values, ``h`` and ``c`` must agree within atol = rtol =
1e-5 (float32; the port pools the encoder's tokens through a histogram and
one matrix product, which sums in another order than the flax encoder).
The flax tree written back by ``params_to_flax`` equals the one read.
The reference checkpoint layout (``_net.0``, ``_rnn.*_l0``, ...) loads into
the port's native ``TorchRefLSTMNet`` and gives the logits of the JAX
package's flax twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mettagrid_tpu.policy import lstm as jlstm
from mettagrid_tpu.policy import torch_compat as jcompat
from mettagrid_tpu.policy.puffer_default import PufferDefaultNet as JPufferDefaultNet
from mettagrid_tpu.policy.stateless import StatelessPolicyNet as JStatelessPolicyNet
from mettagrid_tpu.policy.token_encoder import TokenEncoder as JTokenEncoder
from mettagrid_tpu_torch.policy import (
    LSTMPolicy,
    LSTMState,
    PufferDefaultNet,
    StatelessPolicyNet,
    TokenEncoder,
    params_from_flax,
    params_to_flax,
    unroll,
)
from mettagrid_tpu_torch.policy.torch_compat import TorchCompatLSTMPolicy, TorchLSTMState, TorchRefLSTMNet

TOL = dict(atol=1e-5, rtol=1e-5)
N_ACTIONS = 7


def tokens(rng, shape, T):
    """Token observations as an env gives them: location bytes in the 13 x
    13 window or 0xFE (global), EMPTY (0xFF) past a random count per
    agent, any feature id and value."""
    tok = np.empty((*shape, T, 3), np.uint8)
    r, c = rng.integers(0, 13, (2, *shape, T))
    tok[..., 0] = np.where(rng.random((*shape, T)) < 0.1, 0xFE, (r << 4) | c)
    tok[..., 1] = rng.integers(0, 256, (*shape, T))
    tok[..., 2] = rng.integers(0, 256, (*shape, T))
    count = rng.integers(0, T + 1, shape)
    tok[np.arange(T) >= count[..., None]] = 0xFF
    tok.reshape(-1, T, 3)[0] = 0xFF  # an agent with no valid token
    return tok


def state(rng, shape, H):
    return [rng.standard_normal((*shape, H)).astype(np.float32) for _ in range(2)]


def flax_init(module, *args):
    return jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(3), *args))


def close(port, ref, what):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL, err_msg=what)


def tree_equal(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            tree_equal(a[k], b[k], f"{where}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=where)


@pytest.mark.parametrize("norms", [(), (4.0, 0.5, 30.0, 1.0, 7.0)], ids=["no_norms", "norms"])
def test_token_encoder(norms):
    rng = np.random.default_rng(0)
    tok = tokens(rng, (3, 5), 40)
    jenc = JTokenEncoder(hidden_size=24, feature_norms=norms)
    params = flax_init(jenc, jnp.asarray(tok))
    enc = params_from_flax(TokenEncoder(hidden_size=24, feature_norms=norms, device="cpu"), params)
    with torch.no_grad():
        close(enc(torch.from_numpy(tok)), jax.jit(jenc.apply)(params, jnp.asarray(tok)), "encoding")
    tree_equal(params, params_to_flax(enc))


@pytest.mark.parametrize("widths", [(16, 24), (128, 192)], ids=["narrow", "default"])
def test_lstm_policy(widths):
    """One step from a random state over a [2, 3] batch of agents, at narrow
    widths and at the defaults (hidden 128, encoder 192)."""
    hidden, enc = widths
    rng = np.random.default_rng(1)
    tok = tokens(rng, (2, 3), 60)
    h, c = state(rng, (2, 3), hidden)
    jnet = jlstm.LSTMPolicy(num_actions=N_ACTIONS, hidden_size=hidden, encoder_hidden=enc)
    params = flax_init(jnet, jnp.asarray(tok), jlstm.LSTMState(h=jnp.asarray(h), c=jnp.asarray(c)))
    net = params_from_flax(LSTMPolicy(N_ACTIONS, hidden, enc, device="cpu"), params)
    jl, jv, js = jax.jit(jnet.apply)(params, jnp.asarray(tok), jlstm.LSTMState(h=jnp.asarray(h), c=jnp.asarray(c)))
    with torch.no_grad():
        tl, tv, ts = net(torch.from_numpy(tok), LSTMState(torch.from_numpy(h), torch.from_numpy(c)))
    for what, got, want in (("logits", tl, jl), ("value", tv, jv), ("h", ts.h, js.h), ("c", ts.c, js.c)):
        assert tuple(got.shape) == want.shape, what
        close(got, want, what)
    tree_equal(params, params_to_flax(net))


def test_lstm_unroll():
    """unroll over 4 steps from the zero state, time leading."""
    rng = np.random.default_rng(2)
    tok = tokens(rng, (4, 5), 30)
    jnet = jlstm.LSTMPolicy(num_actions=N_ACTIONS, hidden_size=16, encoder_hidden=24)
    jstate = jlstm.LSTMState(h=jnp.zeros((5, 16)), c=jnp.zeros((5, 16)))
    params = flax_init(jnet, jnp.asarray(tok[0]), jstate)
    net = params_from_flax(LSTMPolicy(N_ACTIONS, 16, 24, device="cpu"), params)
    jl, jv, js = jax.jit(lambda p, t, st: jlstm.unroll(jnet, p, t, st))(params, jnp.asarray(tok), jstate)
    with torch.no_grad():
        tl, tv, ts = unroll(net, torch.from_numpy(tok), net.initial_state((5,)))
    assert tuple(tl.shape) == (4, 5, N_ACTIONS) and tuple(tv.shape) == (4, 5)
    for what, got, want in (("logits", tl, jl), ("values", tv, jv), ("h", ts.h, js.h), ("c", ts.c, js.c)):
        close(got, want, what)


@pytest.mark.parametrize("hidden", [32, 256], ids=["narrow", "default"])
def test_puffer_default_net(hidden):
    rng = np.random.default_rng(3)
    T = 20
    tok = tokens(rng, (6,), T)
    h, c = state(rng, (6,), hidden)
    jnet = JPufferDefaultNet(num_actions=N_ACTIONS, hidden_size=hidden)
    jstate = jlstm.LSTMState(h=jnp.asarray(h), c=jnp.asarray(c))
    params = flax_init(jnet, jnp.asarray(tok), jstate)
    net = params_from_flax(PufferDefaultNet(N_ACTIONS, T * 3, hidden, device="cpu"), params)
    jl, jv, js = jax.jit(jnet.apply)(params, jnp.asarray(tok), jstate)
    with torch.no_grad():
        tl, tv, ts = net(torch.from_numpy(tok), LSTMState(torch.from_numpy(h), torch.from_numpy(c)))
    for what, got, want in (("logits", tl, jl), ("value", tv, jv), ("h", ts.h, js.h), ("c", ts.c, js.c)):
        close(got, want, what)
    tree_equal(params, params_to_flax(net))


@pytest.mark.parametrize("hidden", [16, 128], ids=["narrow", "default"])
def test_stateless_net(hidden):
    rng = np.random.default_rng(4)
    T = 20
    tok = tokens(rng, (2, 3), T)
    jnet = JStatelessPolicyNet(num_actions=N_ACTIONS, hidden_size=hidden)
    params = flax_init(jnet, jnp.asarray(tok))
    net = params_from_flax(StatelessPolicyNet(N_ACTIONS, T * 3, hidden, device="cpu"), params)
    jl, jv = jax.jit(jnet.apply)(params, jnp.asarray(tok))
    with torch.no_grad():
        tl, tv = net(torch.from_numpy(tok))
    close(tl, jl, "logits")
    close(tv, jv, "value")
    tree_equal(params, params_to_flax(net))


def _ref_obs(rng, A, T):
    return rng.integers(0, 256, (A, T, 3)).astype(np.uint8)


def test_native_reference_net_against_flax_twin():
    """The flax twin's tree (its two LSTM biases summed into ``ih``) carried
    into the native net; four recurrent steps."""
    rng = np.random.default_rng(5)
    A, T, H = 5, 20, 32
    jnet = jcompat.TorchRefLSTMNet(num_actions=N_ACTIONS, obs_size=T * 3, hidden_size=H)
    z = jnp.zeros((A, H))
    params = flax_init(jnet, jnp.zeros((A, T * 3)), jcompat.TorchLSTMState(h=z, c=z))
    net = params_from_flax(TorchRefLSTMNet(N_ACTIONS, T * 3, H, device="cpu"), params)
    jstate = jcompat.TorchLSTMState(h=z, c=z)
    tstate = TorchLSTMState(h=torch.zeros(A, H), c=torch.zeros(A, H))
    apply = jax.jit(jnet.apply)
    for step in range(4):
        obs = (_ref_obs(rng, A, T).reshape(A, -1) / 255.0).astype(np.float32)
        jl, jv, jstate = apply(params, jnp.asarray(obs), jstate)
        with torch.no_grad():
            tl, tv, tstate = net(torch.from_numpy(obs), tstate)
        close(tl, jl, f"logits at step {step}")
        close(tv, jv, f"value at step {step}")
        close(tstate.c, jstate.c, f"c at step {step}")


class RefNet(torch.nn.Module):
    """The reference LSTMPolicyNet's layout (as tests/policy/test_torch_compat.py)."""

    def __init__(self, obs_size, H):
        super().__init__()
        self._net = torch.nn.Sequential(torch.nn.Linear(obs_size, H), torch.nn.ReLU(), torch.nn.Linear(H, H))
        self._rnn = torch.nn.LSTM(H, H, batch_first=True)
        self._action_head = torch.nn.Linear(H, N_ACTIONS)
        self._value_head = torch.nn.Linear(H, 1)


def test_reference_state_dict_matches_jax_twin(tmp_path):
    """Twin of tests/policy/test_torch_compat.py: a reference-layout state
    dict loads into the native net by ``load_state_dict`` and gives the
    logits and values of the JAX package's ``TorchRefLSTMNet`` under
    ``torch_state_dict_to_params``, over four recurrent steps; the
    checkpoint file drives ``TorchCompatLSTMPolicy`` to the argmax of those
    logits, and its sampled mode stays in range."""
    torch.manual_seed(0)
    A, T, H = 5, 20, 32
    sd = RefNet(T * 3, H).state_dict()
    net = TorchRefLSTMNet(N_ACTIONS, T * 3, H, device="cpu")
    net.load_state_dict(sd)
    assert set(net.state_dict()) == set(sd)
    jnet = jcompat.TorchRefLSTMNet(num_actions=N_ACTIONS, obs_size=T * 3, hidden_size=H)
    jparams = jcompat.torch_state_dict_to_params(sd, hidden_size=H)
    apply = jax.jit(jnet.apply)
    rng = np.random.default_rng(1)
    jstate = jcompat.TorchLSTMState(h=jnp.zeros((A, H)), c=jnp.zeros((A, H)))
    tstate = TorchLSTMState(h=torch.zeros(A, H), c=torch.zeros(A, H))
    path = tmp_path / "ref_lstm.pt"
    torch.save(sd, str(path))
    policy = TorchCompatLSTMPolicy(N_ACTIONS, T * 3, checkpoint_path=str(path), hidden_size=H, device="cpu")
    sampled = TorchCompatLSTMPolicy(N_ACTIONS, T * 3, state_dict=sd, hidden_size=H, deterministic=False,
                                    device="cpu")
    for step in range(4):
        raw = _ref_obs(rng, A, T)
        obs = (raw.reshape(A, -1) / 255.0).astype(np.float32)
        jl, jv, jstate = apply(jparams, jnp.asarray(obs), jstate)
        with torch.no_grad():
            tl, tv, tstate = net(torch.from_numpy(obs), tstate)
        close(tl, jl, f"logits at step {step}")
        close(tv, jv, f"value at step {step}")
        acts = np.zeros(A, np.int32)
        policy.step_batch(raw, acts)
        np.testing.assert_array_equal(acts, tl.argmax(-1).numpy())
        sampled.step_batch(raw, acts)
        assert acts.min() >= 0 and acts.max() < N_ACTIONS
