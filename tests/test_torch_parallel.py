"""The port's multi-device path (``mettagrid_tpu_torch.parallel``: the
mesh, the sharded trainer, the dryrun and the rig) on the CPU, over Gloo.

Rank processes are spawned with ``python -m`` on free ports of 127.0.0.1:
the rig (``mettagrid_tpu_torch.parallel.rig``) and, for the mesh helpers,
tests/torch_mesh_worker.py. A one-rank group in this process runs what
needs no second rank: refusals, counted collectives, one process's run on
the full batch.

- Mesh helpers on 2 ranks and on a 2x2 mesh: each rank's rows, ranks of one
  data index alike, ``gather_batch(shard_batch(x)) == x``, ``replicate``
  bit-equal, 6 envs refused on 4 data ranks.
- The env step over 2 ranks (twins of tests/test_multichip.py:46, :73):
  16 envs, 12 steps of seeded actions and agent orders, every state field,
  the observations and the rewards bit-equal to this process stepping all
  16; each rank's outputs hold its rows on its device.
- The rig's sharded trainer (twin of tests/test_multiprocess.py:30): both
  ranks print the same losses; the first within rtol 1e-6 of one process
  on the full batch, the second within 1e-5 relative.
- Against the JAX package's trainer (make_train_step, external_perm, E 4,
  A 4, 3 steps, actions recomputed from ``ts.key`` as
  tests/test_torch_train.py does), replayed by two port ranks: under
  ``optax.sgd(1.0)`` / ``torch.optim.SGD(lr=1.0)`` the parameter change per
  leaf within atol 1e-6, rtol 1e-4, the metrics within rtol 1e-5, the env
  state and observations exact; under Adam 1e-3 the parameters within atol
  1e-5 after each step, with test_torch_train's ε-noise exemption.
- The 2x2 mesh (model_parallel=2) replaying the Adam run: the model
  replicas of each data shard bit-equal, and the result within atol 1e-6
  of the 2-rank run.
- One gradient all-reduce per train step over the "data" group, and no
  host read inside the step; ``dryrun_multichip(2, device="cpu")``;
  ``make_mesh`` refusals.
"""

import contextlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import mettagrid_tpu.builder as jbuilder
import mettagrid_tpu.engine as jengine
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu.parallel import train as jtrain
from mettagrid_tpu.policy import lstm as jlstm
from mettagrid_tpu_torch.parallel import TrainState, make_mesh, make_train_step
from mettagrid_tpu_torch.parallel import dryrun, rig
from mettagrid_tpu_torch.policy import LSTMPolicy
from tests.test_torch_step import _jax_state_numpy
from tests.test_torch_train import EPS, GRAD_TOL, LR, MAX_STEERED, METRIC_TOL, _flat, _names, _recording, tree_close, \
    tree_sub
from tests.torch_mesh_worker import full_batch

A, H = 4, 32
TIMEOUT = 240


def _spawn(module: str, args_of_rank, world: int) -> list[subprocess.Popen]:
    return [subprocess.Popen([sys.executable, "-m", module, *map(str, args_of_rank(r))], cwd=dryrun.REPO, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]


def _finish(procs: list[subprocess.Popen]) -> list[str]:
    """Each rank's output; fails unless every rank exits 0."""
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def _rig(world: int, *args) -> list[subprocess.Popen]:
    port = dryrun.free_port()
    return _spawn("mettagrid_tpu_torch.parallel.rig", lambda r: (r, world, port, "--device", "cpu", *args), world)


@contextlib.contextmanager
def one_rank_group():
    """A Gloo group of this process alone, and its (1, 1) mesh."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{dryrun.free_port()}", world_size=1, rank=0)
    try:
        yield make_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Rank processes that need nothing of this process, started at once:
    the mesh workers on 2 and 4 ranks and the rig on 2 ranks at 16 envs."""
    out = tmp_path_factory.mktemp("parallel")
    procs = {}
    for world, mp in ((2, 1), (4, 2)):
        port = dryrun.free_port()
        procs[f"mesh{world}"] = _spawn("tests.torch_mesh_worker",
                                       lambda r, w=world, p=port, m=mp: (r, w, p, m, out / f"mesh{w}_"), world)
    procs["rig"] = _rig(2, "--envs", 16, "--out", out / "rig.npz")
    return out, procs


@pytest.fixture(scope="module")
def mesh_runs(started):
    out, procs = started
    runs = {}
    for world in (2, 4):
        _finish(procs[f"mesh{world}"])
        runs[world] = [dict(np.load(out / f"mesh{world}_{r}.npz")) for r in range(world)]
    return runs


@pytest.fixture(scope="module")
def rig_run(started):
    out, procs = started
    outs = _finish(procs["rig"])
    return outs, rig.read_result(out / "rig.npz")


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_rows_and_gather(mesh_runs, world):
    """Each rank holds its data index's rows; ranks of one data index hold
    the same rows; gather_batch(shard_batch(x)) == x on every rank."""
    ints, bools, floats, lstm = (x.numpy() if isinstance(x, torch.Tensor) else x for x in full_batch())
    mp = 1 if world == 2 else 2
    n_data = world // mp
    k = len(ints) // n_data
    for r, got in enumerate(mesh_runs[world]):
        d = r // mp
        assert (int(got["data"]), int(got["model"])) == (d, r % mp)
        rows = slice(d * k, (d + 1) * k)
        for name, full in (("ints", ints), ("bools", bools), ("floats", floats), ("h", lstm.h.numpy()),
                           ("c", lstm.c.numpy())):
            assert got[name].dtype == full.dtype, name
            np.testing.assert_array_equal(got[name], full[rows], err_msg=f"rank {r} {name}")
            np.testing.assert_array_equal(got["g_" + name], full, err_msg=f"rank {r} gathered {name}")


@pytest.mark.parametrize("world", [2, 4])
def test_replicate_makes_ranks_bit_equal(mesh_runs, world):
    """Every rank seeded its policy apart; after replicate every rank holds
    rank 0's bits, and a replicated tree holds rank 0's leaves."""
    runs = mesh_runs[world]
    assert not np.array_equal(runs[0]["params"][:8], np.zeros(8))
    for r, got in enumerate(runs):
        assert got["params"].tobytes() == runs[0]["params"].tobytes(), f"rank {r}"
        np.testing.assert_array_equal(got["tree_w"], np.zeros(3, np.float32))
        np.testing.assert_array_equal(got["tree_b"], np.array([False]))


def test_shard_batch_refuses_uneven_split(mesh_runs):
    """6 envs on 4 data ranks raise, as NamedSharding does."""
    for got in mesh_runs[4]:
        assert "does not split over 4 data ranks" in str(got["refused"])


def test_make_mesh_refusals(monkeypatch):
    """No group: make_mesh raises. In a group of one: 3 devices with
    model_parallel=2 raise, 2 devices in a group of 1 raise, and
    device=None without a card raises instead of running on the CPU."""
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, device="cpu")
    with one_rank_group():
        with pytest.raises(ValueError, match="model_parallel=2"):
            make_mesh(3, model_parallel=2, device="cpu")
        with pytest.raises(ValueError, match="process group of 2"):
            make_mesh(2, device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1)


def _step_all(num_envs: int):
    """This process stepping all ``num_envs`` envs as the rig's part 1 does."""
    program, reset, step = dryrun.build_env(A, num_envs, "cpu")
    state, out = reset(0)
    rng = np.random.default_rng(0)
    for _ in range(rig.PARITY_STEPS):
        acts = rng.integers(0, len(program.action_names), (num_envs, A)).astype(np.int32)
        perm, maps = dryrun.fed_draws(rng, num_envs, A, dryrun.POOL)
        state, out = step(state, torch.from_numpy(acts), torch.zeros((num_envs, A), dtype=torch.int32),
                          torch.from_numpy(perm), reset_maps=torch.from_numpy(maps))
    return state, out


def test_sharded_step_equals_one_process(rig_run):
    """Twin of test_sharded_step_signature_equals_single_device: 16 envs
    over 2 ranks, gathered, equal this process stepping all 16."""
    _, got = rig_run
    state, out = _step_all(16)
    for name, want in state._asdict().items():
        np.testing.assert_array_equal(got["state"][name], want.numpy(), err_msg=f"state field {name}")
    np.testing.assert_array_equal(got["obs"], out.observations.numpy())
    np.testing.assert_array_equal(got["rewards"], out.rewards.numpy())
    assert got["obs"].shape[0] == 16 and (got["obs"] > 0).any()


def test_sharded_outputs_hold_local_rows(rig_run):
    """Twin of test_sharded_outputs_live_on_the_mesh: rank r held rows
    8r..8r+8 and its sharded step's observations have those 8 rows (the rig
    also checks every state field and output on the rank's device, and
    exits non-zero where one is not)."""
    outs, got = rig_run
    np.testing.assert_array_equal(got["rank_rows"], [[0, 8, 8], [8, 16, 8]])
    for r, out in enumerate(outs):
        assert f"RIG_OK rank={r}" in out


def test_two_process_losses_match_one_process(rig_run):
    """Twin of test_two_process_mesh_matches_single_process."""
    outs, got = rig_run
    losses = [tuple(float.fromhex(t) for t in ln.split()[1:]) for out in outs for ln in out.splitlines()
              if ln.startswith("RIG_LOSSES ")]
    assert len(losses) == 2 and losses[0] == losses[1], losses
    assert tuple(got["losses"]) == losses[0]
    with one_rank_group() as mesh:
        local = dryrun.train_losses_multichip(mesh, 16, A, 2)
    assert abs(local[0] - losses[0][0]) <= 1e-6 * abs(local[0]), (local, losses[0])
    assert abs(local[1] - losses[0][1]) <= 1e-5 * max(1.0, abs(local[1])), (local, losses[0])


class _Counted:
    """Counts the torch.distributed collectives called, with their groups."""

    NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "reduce_scatter", "all_to_all",
             "barrier", "reduce", "gather", "scatter")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in self.NAMES:
            real = getattr(dist, name)
            monkeypatch.setattr(dist, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def call(*args, **kw):
            self.calls.append((name, kw.get("group")))
            return real(*args, **kw)

        return call


def test_one_all_reduce_per_step_and_no_host_read(monkeypatch):
    """The sharded step makes one all-reduce over the "data" group a train
    step and no other collective; the env step alone makes none; the
    trainer's own code reads no tensor on the host inside the step (the env
    step's wave loop reads whether its waves have settled, as it does under
    the one-device trainer); the metrics are 0-dim tensors; with a one-rank
    mesh the step, its own draw included, equals the one-device step."""
    with one_rank_group() as mesh:
        E = 4
        program, reset, step = dryrun.build_env(A, E, "cpu")
        gen = torch.Generator()
        gen.manual_seed(0)
        start = LSTMPolicy(len(program.action_names), H, H, device="cpu", generator=gen).state_dict()
        in_env = []

        def env_step(*args, **kw):
            in_env.append(True)
            try:
                return step(*args, **kw)
            finally:
                in_env.pop()

        runs = {}
        for name, m in (("one device", None), ("mesh", mesh)):
            policy = LSTMPolicy(len(program.action_names), H, H, device="cpu")
            policy.load_state_dict(start)
            optimizer = torch.optim.SGD(policy.parameters(), lr=0.1)
            train_step = make_train_step(program, env_step, policy, optimizer, mesh=m)
            state, out = reset(0)
            draw = torch.Generator()
            draw.manual_seed(3)
            runs[name] = (policy, train_step, TrainState(state, out.observations, policy.initial_state((E, A)), draw))
        counted = _Counted(monkeypatch)
        perm = torch.from_numpy(dryrun.fed_draws(np.random.default_rng(1), E, A, dryrun.POOL)[0])
        zeros = torch.zeros((E, A), dtype=torch.int32)
        step(reset(0)[0], zeros, zeros, perm)
        assert counted.calls == []

        reads = ("item", "tolist", "numpy", "__bool__", "__float__", "__int__")
        originals = {attr: getattr(torch.Tensor, attr) for attr in reads}

        def guard(attr):
            def call(self, *args, **kw):
                if not in_env:
                    raise AssertionError(f"Tensor.{attr}: a host read by the trainer inside its step")
                return originals[attr](self, *args, **kw)

            return call

        policy, train_step, ts = runs["mesh"]
        _, one_step, one_ts = runs["one device"]
        for i in range(3):
            with monkeypatch.context() as m:
                for attr in reads:
                    m.setattr(torch.Tensor, attr, guard(attr))
                ts, metrics = train_step(ts, perm=perm)
                one_ts, one_metrics = one_step(one_ts, perm=perm)
            assert counted.calls == [("all_reduce", mesh.get_group("data"))] * (i + 1)
            assert all(v.dim() == 0 for v in metrics.values())
            assert all(torch.equal(metrics[k], one_metrics[k]) for k in metrics)
        assert all(torch.equal(p, q) for p, q in zip(policy.parameters(), runs["one device"][0].parameters()))
        assert torch.equal(ts.env_state.agent_last_action, one_ts.env_state.agent_last_action)


def test_dryrun_multichip_two_ranks():
    outs = dryrun.dryrun_multichip(2, device="cpu")
    for r, out in enumerate(outs):
        assert f"RIG_OK rank={r}" in out and "RIG_LOSSES " in out


# --- against the JAX package's trainer ---

E_JAX, N_JAX = 4, 3


class JaxRun:
    """The JAX trainer on the dryrun arena with external_perm, stepped with
    its own draws (recomputed from ts.key) and one numpy agent order a
    step; keeps the start, each step's actions, orders, metrics,
    parameters and (through a recording optimizer) gradients."""

    def __init__(self, optimizer, recording: bool = False):
        cfg = jbuilder.make_arena(A, combat=False, map_builder=JRandomMapBuilder.Config(
            agents=A, width=16, height=16, border_width=1, objects={"wall": 6}))
        program = jengine.compile_program(cfg)
        builder = cfg.game.map_builder.create()
        maps = []
        for i in range(dryrun.POOL):
            builder.config.seed = i
            maps.append(builder.build_for_num_agents(A))
        init = jengine.build_env_init(program, maps)
        jstep = jengine.make_step(program, init, auto_reset=True, donate=False, external_perm=True)
        net = jlstm.LSTMPolicy(num_actions=len(program.action_names), hidden_size=H, encoder_hidden=H)
        state, out = jengine.make_reset(program, init, E_JAX)(0)
        lstate = net.initial_state((E_JAX, A))
        params = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), out.observations, lstate))
        self.start = (state, out.observations, params)

        @jax.jit
        def draw(ts):
            _, k_act = jax.random.split(ts.key)
            logits, _, _ = net.apply(ts.params, ts.obs, ts.lstm_state)
            return jax.random.categorical(k_act, logits).astype(jnp.int32)

        @jax.jit
        def train(ts, perm):
            return jtrain.make_train_step(program, lambda s, a, v: jstep(s, a, v, perm), net, optimizer)(ts)

        ts = jtrain.TrainState(params=params, opt_state=optimizer.init(params), env_state=state,
                               obs=out.observations, lstm_state=lstate, key=jax.random.PRNGKey(1))
        rng = np.random.default_rng(5)
        self.actions, self.perm, self.reset_maps, self.metrics, self.params, self.grads = [], [], [], [], [], []
        for _ in range(N_JAX):
            self.actions.append(np.array(draw(ts)))
            perm, maps = dryrun.fed_draws(rng, E_JAX, A, dryrun.POOL)
            ts, m = train(ts, jnp.asarray(perm))
            self.perm.append(perm)
            self.reset_maps.append(maps)
            self.metrics.append({k: float(v) for k, v in m.items()})
            self.params.append(jax.device_get(ts.params))
            self.grads.append(jax.device_get(ts.opt_state[0]) if recording else None)
        self.end = ts

    def write(self, path, optimizer: str, lr: float):
        state, obs, params = self.start
        rig.write_replay(path, state=_jax_state_numpy(state), obs=np.asarray(obs), params=params,
                         actions=np.stack(self.actions), perm=np.stack(self.perm),
                         reset_maps=np.stack(self.reset_maps), optimizer=optimizer, lr=lr)


@pytest.fixture(scope="module")
def replays(started, tmp_path_factory):
    """The JAX runs under SGD and Adam, replayed by 2 port ranks each and
    the Adam run by the 2x2 mesh, all ranks at once."""
    out = tmp_path_factory.mktemp("replay")
    runs = {"sgd": JaxRun(optax.sgd(1.0)), "adam": JaxRun(_recording(optax.adam(LR)), recording=True)}
    runs["sgd"].write(out / "sgd_in.npz", "sgd", 1.0)
    runs["adam"].write(out / "adam_in.npz", "adam", LR)
    procs = {name: _rig(world, "--model-parallel", mp, "--replay", out / f"{opt}_in.npz", "--out",
                        out / f"{name}.npz")
             for name, opt, world, mp in (("sgd", "sgd", 2, 1), ("adam", "adam", 2, 1), ("adam2x2", "adam", 4, 2))}
    for name, p in procs.items():
        outs = _finish(p)
        assert all(f"RIG_OK rank={r}" in o for r, o in enumerate(outs)), name
    return runs, {name: rig.read_result(out / f"{name}.npz") for name in procs}


def _check_end(run: JaxRun, got: dict, lstm_atol: float):
    want = _jax_state_numpy(run.end.env_state)
    for name, ref in want.items():
        if name != "rng":
            np.testing.assert_array_equal(got["state"][name], ref, err_msg=f"state field {name}")
    np.testing.assert_array_equal(got["obs"], np.asarray(run.end.obs))
    np.testing.assert_allclose(got["lstm_h"], np.asarray(run.end.lstm_state.h), atol=lstm_atol, rtol=0)
    np.testing.assert_allclose(got["lstm_c"], np.asarray(run.end.lstm_state.c), atol=lstm_atol, rtol=0)


def test_sharded_gradients_match_jax_under_sgd(replays):
    runs, results = replays
    run, got = runs["sgd"], results["sgd"]
    before_j = before_t = run.start[2]
    for s, (jm, step) in enumerate(zip(run.metrics, got["steps"])):
        for name in ("loss", "entropy", "reward_mean"):
            np.testing.assert_allclose(step[name], jm[name], rtol=METRIC_TOL["rtol"], err_msg=f"step {s}: {name}")
        tree_close(tree_sub(step["params"], before_t), tree_sub(run.params[s], before_j), f"step {s}: gradient",
                   **GRAD_TOL)
        before_j, before_t = run.params[s], step["params"]
    _check_end(run, got, 1e-5)
    assert list(got["rank_launches"]) == [0, 0]  # the CPU route launches no kernel


def test_sharded_adam_matches_optax(replays):
    """The parameters within 1e-5 of optax's after each step, but for at most
    MAX_STEERED components whose gradient lies within 10 eps of 0 on a step
    where the two gradients differ by more than 1e-3 of |g| + eps: each such
    step may move them up to LR apart (tests/test_torch_train._adam_run).
    The gradients are held by the SGD test: under Adam the parameters after
    the first step differ from optax's by up to 1.3e-7, and on this arena
    that moves one gradient of the second step (the encoder's Dense_0
    bias[2], 0.0221) by 1.9e-4 relative, in a one-rank replay as in a
    two-rank one."""
    runs, results = replays
    run, got = runs["adam"], results["adam"]
    slack = 0.0
    for s, (jm, step) in enumerate(zip(run.metrics, got["steps"])):
        for name in ("loss", "entropy", "reward_mean"):
            np.testing.assert_allclose(step[name], jm[name], rtol=METRIC_TOL["rtol"], atol=0.0 if s == 0 else 1e-5,
                                       err_msg=f"step {s}: {name}")
        g_jax, g_port = _flat(run.grads[s]), _flat(step["grads"])
        noise = (np.maximum(np.abs(g_port), np.abs(g_jax)) <= 10 * EPS) & \
            (np.abs(g_port - g_jax) > 1e-3 * (np.abs(g_jax) + EPS))
        slack = slack + LR * noise
        diff = np.abs(_flat(step["params"]) - _flat(run.params[s]))
        bad = diff > 1e-5 + slack
        assert not bad.any(), f"step {s}: {bad.sum()} params differ from optax's by up to {diff[bad].max():.3g}"
        loose = np.flatnonzero(diff > 1e-5)
        names = _names(run.params[s])
        assert len(loose) <= MAX_STEERED, f"step {s}: {[names[k] for k in loose[:8]]}"
    _check_end(run, got, 1e-4)


def test_two_by_two_mesh_replicas_and_result(replays):
    """On the 2x2 mesh the two model replicas of each data shard end
    bit-equal, and the run equals the 2-rank run within atol 1e-6."""
    _, results = replays
    two, grid = results["adam"], results["adam2x2"]
    ranks = grid["rank_params"]
    assert ranks.shape[0] == 4
    for d in range(2):
        assert ranks[2 * d].tobytes() == ranks[2 * d + 1].tobytes(), f"data shard {d}"
    np.testing.assert_allclose(ranks, np.broadcast_to(two["rank_params"][0], ranks.shape), atol=1e-6, rtol=0)
    for s, (a, b) in enumerate(zip(two["steps"], grid["steps"])):
        np.testing.assert_allclose(b["loss"], a["loss"], atol=1e-6, rtol=0, err_msg=f"step {s}")
    for name, ref in two["state"].items():
        np.testing.assert_array_equal(grid["state"][name], ref, err_msg=f"state field {name}")
    np.testing.assert_array_equal(grid["obs"], two["obs"])

