"""The port's learner (``mettagrid_tpu_torch.parallel.make_train_step``) in
lockstep with the JAX package's, on the CPU.

Both packages compile one small arena (4 agents, 2 envs) and train an
LSTMPolicy of widths 32 from the same flax parameters, carried into the
port by ``policy/interop.params_from_flax``; the port starts from the JAX
reset state (engine/interop.py). Each step the actions are the JAX
trainer's own draw, recomputed from ``ts.key`` as train.py draws them and
fed to the port's ``actions=``, and one agent order drawn with numpy goes
to both engines through ``external_perm``.

- Gradients: under ``optax.sgd(1.0)`` and ``torch.optim.SGD(lr=1.0)`` the
  parameter change is the negative gradient; per leaf atol 1e-6, rtol 1e-4.
- Loss, entropy and reward mean: rtol 1e-5. Env state and observations:
  exact. LSTM state: atol 1e-5 (float32; the encoder pools in another
  order than flax).
- ``optax.adam(1e-3)`` against the port's ``adam``: the parameters through
  ``params_to_flax`` within atol 1e-5 after each of 4 steps, but for at
  most 4 components whose gradient lies within 10·eps of 0, where float32
  noise sets Adam's step (``_adam_run``; on this arena one component).

The traps: an Adam over ``policy.parameters()`` with ``bias_ih`` trained
fails that comparison; a loss pass run after the env step has rewritten
the carried observations fails the loss comparison; a carried LSTM state
that still holds its graph makes the next step raise, and the trainer's
own carried state holds none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mettagrid_tpu.builder as jbuilder
import mettagrid_tpu.engine as jengine
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu.parallel import train as jtrain
from mettagrid_tpu.policy import lstm as jlstm
from mettagrid_tpu_torch import builder as tbuilder
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.engine.interop import state_from_numpy
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from mettagrid_tpu_torch.parallel import TrainState, adam, make_train_step
from mettagrid_tpu_torch.parallel.train import a2c_loss
from mettagrid_tpu_torch.policy import LSTMPolicy, LSTMState, params_from_flax, params_to_flax
from mettagrid_tpu_torch.policy.interop import _to_flax
from tests.test_torch_step import _assert_states_equal, _jax_state_numpy

A, E, H = 4, 2, 32
METRIC_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
LR = 1e-3


def _arena(eng, builder_mod, rmb):
    cfg = builder_mod.make_arena(
        A, combat=False, map_builder=rmb.Config(agents=A, width=11, height=11, border_width=1, objects={"wall": 6})
    )
    cfg.game.max_steps = 40
    program = eng.compile_program(cfg)
    b = cfg.game.map_builder.create()
    b.config.seed = 3
    return program, eng.build_env_init(program, [b.build_for_num_agents(A)])


class JaxSide:
    """The JAX engine, net, reset and jitted pieces, built once per module:
    each optimizer's jitted trainer is compiled on first use."""

    def __init__(self):
        jp, ji = _arena(jengine, jbuilder, JRandomMapBuilder)
        self.jstep = jengine.make_step(jp, ji, auto_reset=True, donate=False, external_perm=True)
        self.program = jp
        self.net = jlstm.LSTMPolicy(num_actions=len(jp.action_names), hidden_size=H, encoder_hidden=H)
        self.state, self.out = jengine.make_reset(jp, ji, E)(0)
        self.lstate = self.net.initial_state((E, A))
        self.params = jax.device_get(jax.jit(self.net.init)(jax.random.PRNGKey(0), self.out.observations,
                                                            self.lstate))
        net = self.net

        @jax.jit
        def actions(ts):
            # train.py:59-62: the key split and the categorical draw.
            _, k_act = jax.random.split(ts.key)
            logits, _, _ = net.apply(ts.params, ts.obs, ts.lstm_state)
            return jax.random.categorical(k_act, logits).astype(jnp.int32)

        self.actions = actions
        self._trainers = {}

    def trainer(self, name: str, optimizer):
        if name not in self._trainers:
            def fn(ts, perm):
                def step_fn(s, a, v):
                    return self.jstep(s, a, v, perm)

                return jtrain.make_train_step(self.program, step_fn, self.net, optimizer)(ts)

            self._trainers[name] = jax.jit(fn)
        return self._trainers[name]


@pytest.fixture(scope="module")
def jax_side():
    return JaxSide()


class Lockstep:
    """Both trainers from one start: the JAX TrainState and the port's,
    stepped with one set of actions and one agent order a step."""

    def __init__(self, j: JaxSide, opt_name: str, jopt, make_topt):
        self.j = j
        self.jtrain = j.trainer(opt_name, jopt)
        self.jts = jtrain.TrainState(params=j.params, opt_state=jopt.init(j.params), env_state=j.state,
                                     obs=j.out.observations, lstm_state=j.lstate, key=jax.random.PRNGKey(1))
        tp, ti = _arena(tengine, tbuilder, RandomMapBuilder)
        self.tstep = tengine.make_step(tp, ti, auto_reset=True, external_perm=True, device="cpu")
        self.policy = params_from_flax(LSTMPolicy(len(tp.action_names), H, H, device="cpu"), j.params)
        self.perm = None
        self.optimizer = make_topt(self.policy)
        self.train_step = make_train_step(tp, self.step_fn, self.policy, self.optimizer)
        tstate = state_from_numpy(_jax_state_numpy(j.state), "cpu")
        obs = torch.from_numpy(np.asarray(j.out.observations).copy())
        self.ts = TrainState(tstate, obs, self.policy.initial_state((E, A)), torch.Generator())
        self.rng = np.random.default_rng(0)

    def step_fn(self, state, actions, vibes, obs_buf=None):
        return self.tstep(state, actions, vibes, self.perm, obs_buf)

    def step(self):
        """One step of each; returns (JAX metrics, port metrics, actions)."""
        acts = np.array(self.j.actions(self.jts))
        perm = np.stack([self.rng.permutation(A) for _ in range(E)]).astype(np.int32)
        self.jts, jm = self.jtrain(self.jts, jnp.asarray(perm))
        self.perm = torch.from_numpy(perm)
        self.ts, tm = self.train_step(self.ts, actions=torch.from_numpy(acts))
        return jm, tm, acts

    def check_state(self, where: str, lstm_atol: float = 1e-5):
        _assert_states_equal(_jax_state_numpy(self.jts.env_state), self.ts.env_state, where=where)
        np.testing.assert_array_equal(self.ts.obs.numpy(), np.asarray(self.jts.obs), err_msg=f"{where}obs")
        for f in ("h", "c"):
            np.testing.assert_allclose(getattr(self.ts.lstm_state, f).numpy(), np.asarray(getattr(self.jts.lstm_state, f)),
                                       atol=lstm_atol, rtol=0, err_msg=f"{where}lstm {f}")


def check_metrics(jm, tm, where: str, atol: float = 0.0):
    for name in ("loss", "entropy", "reward_mean"):
        got = tm[name]
        assert got.dim() == 0, f"{name} is not a 0-dim tensor"
        np.testing.assert_allclose(float(got), float(jm[name]), rtol=METRIC_TOL["rtol"], atol=atol,
                                   err_msg=f"{where}{name}")


def tree_close(port, ref, where="", **tol):
    if isinstance(ref, dict):
        assert set(port) == set(ref), where
        for k in ref:
            tree_close(port[k], ref[k], f"{where}/{k}", **tol)
    else:
        np.testing.assert_allclose(np.asarray(port), np.asarray(ref), err_msg=where, **tol)


def tree_sub(a, b):
    return {k: tree_sub(a[k], b[k]) for k in a} if isinstance(a, dict) else np.asarray(a) - np.asarray(b)


def test_gradients_match_jax_under_sgd(jax_side):
    run = Lockstep(jax_side, "sgd", optax.sgd(1.0), lambda p: torch.optim.SGD(p.parameters(), lr=1.0))
    for i in range(3):
        j_before, t_before = jax.device_get(run.jts.params), params_to_flax(run.policy)
        jm, tm, _ = run.step()
        where = f"step {i}: "
        check_metrics(jm, tm, where)
        run.check_state(where)
        j_delta = tree_sub(jax.device_get(run.jts.params), j_before)
        t_delta = tree_sub(params_to_flax(run.policy), t_before)
        tree_close(t_delta, j_delta, f"{where}gradient", **GRAD_TOL)
    assert not run.policy.cell.bias_ih.requires_grad and not run.policy.cell.bias_ih.any()
    assert run.ts.lstm_state.h.grad_fn is None and run.ts.lstm_state.c.grad_fn is None


def _flat(tree) -> np.ndarray:
    """A flax tree's leaves in key order, as one float32 vector."""
    if isinstance(tree, dict):
        return np.concatenate([_flat(tree[k]) for k in sorted(tree)])
    return np.asarray(tree, np.float32).ravel()


def _recording(optimizer):
    """``optimizer`` that also keeps the last gradient tree in its state:
    (gradient, the optimizer's own state)."""

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params), optimizer.init(params)

    def update(grads, state, params=None):
        updates, inner = optimizer.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


# Adam's eps, and the most components that float32 noise may steer (see
# _adam_run); on this arena one does.
EPS = 1e-8
MAX_STEERED = 4


def _names(tree, prefix="") -> list[str]:
    """The component names of a flax tree, in _flat's order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}/{k}")]
    return [f"{prefix}[{i}]" for i in range(np.asarray(tree).size)]


def _adam_run(jax_side, make_topt, bias_ih_trained: bool = False, steps: int = 4):
    """The port's Adam trainer against optax.adam(LR)'s, step by step: the
    gradients within GRAD_TOL, the parameters within 1e-5. Returns the
    components that end past 1e-5, each with its distance from optax's
    and its gradients (JAX, port) per step.

    Adam moves a component by about LR·g/(|g| + eps) on its first steps.
    Where a gradient is within 10·eps of 0 on both sides and the two still
    differ by more than 1e-3 of |g| + eps, float32 noise sets that step, up
    to LR apart: such a component's bound grows by LR on that step. At most
    MAX_STEERED components may take that slack; every other stays within
    1e-5. On this arena one does: cell ig kernel [875], whose first nonzero
    gradient is -7.8e-9 in JAX and -1.1e-8 in the port, ends 6.05e-5 apart;
    the rest stay within 4.5e-7. From the second step on it moves the loss
    by up to 7.5e-7 (3.4e-5 relative), hence the metrics' atol 1e-5, and the
    LSTM state by up to 2.3e-5, hence its atol 1e-4. The flax bias's
    gradient is bias_hh's (bias_ih, where it trains, takes the same one)."""
    run = Lockstep(jax_side, "adam", _recording(optax.adam(LR)), make_topt)
    bias_ih = run.policy.cell.bias_ih
    bias_ih.requires_grad_(bias_ih_trained)
    slack, grads = 0.0, []
    for i in range(steps):
        jm, tm, _ = run.step()
        check_metrics(jm, tm, f"step {i}: ", atol=0.0 if i == 0 else 1e-5)
        g_tree = jax.device_get(run.jts.opt_state[0])
        g_jax = _flat(g_tree)
        g_port = _flat(_to_flax(run.policy, lambda p: torch.zeros_like(p) if p.grad is None or p is bias_ih else p.grad))
        np.testing.assert_allclose(g_port, g_jax, err_msg=f"step {i}: gradient", **GRAD_TOL)
        noise = (np.maximum(np.abs(g_port), np.abs(g_jax)) <= 10 * EPS) & \
            (np.abs(g_port - g_jax) > 1e-3 * (np.abs(g_jax) + EPS))
        slack = slack + LR * noise
        grads.append((g_jax, g_port))
        names = _names(g_tree)
        diff = np.abs(_flat(params_to_flax(run.policy)) - _flat(jax.device_get(run.jts.params)))
        bad = diff > 1e-5 + slack
        assert not bad.any(), f"step {i}: {bad.sum()} params differ from optax's by up to {diff[bad].max():.3g}"
        loose = np.flatnonzero(diff > 1e-5)
        assert len(loose) <= MAX_STEERED, \
            f"step {i}: {len(loose)} params past 1e-5 on noise: {[names[k] for k in loose[:8]]}"
    run.check_state("after adam: ", lstm_atol=1e-4)
    return {names[k]: (float(diff[k]), [(float(gj[k]), float(gp[k])) for gj, gp in grads]) for k in loose}


def test_adam_matches_optax(jax_side):
    steered = _adam_run(jax_side, lambda p: adam(p, LR))
    # Each component past 1e-5 took a step on a gradient of the size of eps.
    assert len(steered) <= MAX_STEERED, steered
    assert all(any(0 < max(abs(a), abs(b)) <= 10 * EPS for a, b in g) for _, g in steered.values()), steered


def test_adam_over_every_parameter_fails(jax_side):
    """The trap: Adam over policy.parameters() with the LSTM cell's bias_ih
    trained moves the folded flax bias twice as far as optax does."""
    with pytest.raises(AssertionError, match="params"):
        _adam_run(jax_side, lambda p: torch.optim.Adam(p.parameters(), LR, betas=(0.9, 0.999), eps=1e-8),
                  bias_ih_trained=True)


def test_loss_after_the_obs_write_fails(jax_side):
    """The trap: the carried buffer is rewritten in place by the env step,
    so a loss pass after it reads the new observations. The port's trainer
    matches the JAX loss; the same loss taken after the step does not."""
    run = Lockstep(jax_side, "sgd", optax.sgd(1.0), lambda p: torch.optim.SGD(p.parameters(), lr=1.0))
    acts = np.array(jax_side.actions(run.jts))
    perm = np.stack([run.rng.permutation(A) for _ in range(E)]).astype(np.int32)
    _, jm = run.jtrain(run.jts, jnp.asarray(perm))
    run.perm = torch.from_numpy(perm)
    ts = run.ts
    buf = ts.obs
    before = buf.clone()
    actions = torch.from_numpy(acts)
    env_state, out = run.step_fn(ts.env_state, actions, torch.zeros_like(actions), obs_buf=buf)
    assert out.observations.data_ptr() == buf.data_ptr() and not torch.equal(buf, before), \
        "the step did not rewrite the carried buffer"
    with torch.no_grad():
        late = run.policy(buf, ts.lstm_state)
        early = run.policy(before, ts.lstm_state)
    late_loss, _ = a2c_loss(late[0], late[1], actions, out.rewards, 0.5, 0.01)
    early_loss, _ = a2c_loss(early[0], early[1], actions, out.rewards, 0.5, 0.01)
    np.testing.assert_allclose(float(early_loss), float(jm["loss"]), **METRIC_TOL)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(float(late_loss), float(jm["loss"]), **METRIC_TOL)


def test_carried_state_with_a_graph_raises(jax_side):
    """The trap: a carried LSTM state that still holds the last step's graph
    sends the next backward pass into it, which raises; the trainer detaches
    what it carries, so its second step runs."""
    run = Lockstep(jax_side, "sgd", optax.sgd(1.0), lambda p: torch.optim.SGD(p.parameters(), lr=1.0))
    run.step()
    run.step()
    _, _, attached = run.policy(run.ts.obs, run.ts.lstm_state)
    attached.h.sum().backward(retain_graph=False)
    run.optimizer.zero_grad()
    bad = run.ts._replace(lstm_state=LSTMState(attached.h, attached.c))
    with pytest.raises(RuntimeError, match="backward through the graph a second time"):
        run.train_step(bad, actions=torch.zeros((E, A), dtype=torch.int32))


def test_draws_its_own_actions_and_refuses_tf32(jax_side):
    run = Lockstep(jax_side, "sgd", optax.sgd(1.0), lambda p: torch.optim.SGD(p.parameters(), lr=1.0))
    run.perm = torch.from_numpy(np.stack([run.rng.permutation(A) for _ in range(E)]).astype(np.int32))
    run.ts.generator.manual_seed(5)
    ts, metrics = run.train_step(run.ts)
    assert all(v.dim() == 0 and torch.isfinite(v) for v in metrics.values())
    assert (ts.env_state.step_count == run.ts.env_state.step_count + 1).all()
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            run.train_step(ts)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_mark_names_each_part_once_in_order(jax_side):
    """train_step's mark hook: one call per part, after the part is issued,
    and the step it marks is the same step."""
    plain = Lockstep(jax_side, "sgd", optax.sgd(1.0), lambda p: torch.optim.SGD(p.parameters(), lr=1.0))
    marked = Lockstep(jax_side, "sgd", optax.sgd(1.0), lambda p: torch.optim.SGD(p.parameters(), lr=1.0))
    perm = torch.from_numpy(np.stack([plain.rng.permutation(A) for _ in range(E)]).astype(np.int32))
    plain.perm = marked.perm = perm
    acts = torch.from_numpy(np.array(jax_side.actions(plain.jts)))
    seen = []
    ts_plain, m_plain = plain.train_step(plain.ts, actions=acts)
    ts_marked, m_marked = marked.train_step(marked.ts, actions=acts, mark=seen.append)
    assert seen == ["forward", "env", "backward", "optimizer"]
    assert all(torch.equal(m_plain[k], m_marked[k]) for k in m_plain)
    assert torch.equal(ts_plain.lstm_state.h, ts_marked.lstm_state.h)
    assert all(torch.equal(a, b) for a, b in zip(plain.policy.parameters(), marked.policy.parameters()))
