"""The multi-device dryrun (reference: __graft_entry__.py:16-37, 57-153).

``train_losses_multichip(mesh)`` runs two sharded train steps inside an
initialised process group and returns their losses; ``dryrun_multichip(n)``
spawns n rank processes of the rig (parallel/rig.py), which check the env
step and the trainer across processes, and fails unless each rank prints
``RIG_OK rank=<r>``.
"""

from __future__ import annotations

import pathlib
import socket
import subprocess
import sys

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from mettagrid_tpu_torch.engine.state import resolve_device
from mettagrid_tpu_torch.parallel.mesh import rank_device, replicate, shard_batch
from mettagrid_tpu_torch.parallel.train import TrainState, adam, make_train_step
from mettagrid_tpu_torch.policy import LSTMPolicy

REPO = pathlib.Path(__file__).resolve().parents[2]
POOL = 4  # maps in the dryrun arena's pool


def build_env(num_agents: int, num_envs: int, device, variant: str = "arena"):
    """(program, reset, step) of the dryrun's env: "arena", the reference's
    _build_env (a random 16x16 arena, 6 walls, a pool of POOL maps), or a
    variant of tools/bench_run.py at its pool. The step is made with
    external_perm: the env step draws the agent order and the maps of
    auto-reset envs from a generator of its own, whose draws depend on the
    rows a rank holds, so sharded runs that must equal the full batch feed
    them over the global batch (make_train_step's ``perm``, ``reset_maps``)."""
    from mettagrid_tpu_torch.builder import make_arena
    from mettagrid_tpu_torch.engine import build_env_init, compile_program, make_reset, make_step
    from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder

    if variant == "arena":
        cfg = make_arena(num_agents, combat=False, map_builder=RandomMapBuilder.Config(
            agents=num_agents, width=16, height=16, border_width=1, objects={"wall": 6}))
        program = compile_program(cfg)
        builder = cfg.game.map_builder.create()
        maps = []
        for i in range(POOL):
            builder.config.seed = i
            maps.append(builder.build_for_num_agents(num_agents))
        init = build_env_init(program, maps)
    else:
        from mettagrid_tpu_torch.tools.bench_run import POOL as BENCH_POOL, build_pool, make_cfg

        program, init = build_pool(make_cfg(variant, num_agents), BENCH_POOL)
    reset = make_reset(program, init, num_envs, device=device)
    step = make_step(program, init, auto_reset=True, external_perm=True, device=device)
    return program, reset, step


def fed_draws(rng: np.random.Generator, num_envs: int, num_agents: int, pool: int):
    """One step's agent order int32[E, A] and auto-reset maps int32[E],
    drawn from ``rng`` over the global batch."""
    perm = np.stack([rng.permutation(num_agents) for _ in range(num_envs)]).astype(np.int32)
    return perm, rng.integers(0, pool, num_envs).astype(np.int32)


def train_losses_multichip(mesh: DeviceMesh, num_envs: int | None = None, num_agents: int = 4,
                           steps: int = 2) -> tuple[float, ...]:
    """Sharded train steps on ``mesh`` (inside its process group); returns
    each step's loss. The dryrun arena with ``num_agents`` agents and
    ``num_envs`` envs (2 per rank by default), an LSTMPolicy of widths 32
    and Adam 3e-4, replicated; the actions are drawn over the global batch
    and the agent orders and reset maps fed from numpy, so the losses depend
    on the number of data ranks only through float32 sums."""
    device = rank_device(mesh)
    E = 2 * mesh.size() if num_envs is None else num_envs
    program, reset, step = build_env(num_agents, E, device)
    init_gen, action_gen = torch.Generator(device=device), torch.Generator(device=device)
    init_gen.manual_seed(0)
    action_gen.manual_seed(1)
    policy = replicate(LSTMPolicy(len(program.action_names), 32, 32, device=device, generator=init_gen), mesh)
    train_step = make_train_step(program, step, policy, adam(policy, 3e-4), mesh=mesh)
    state, out = reset(0)
    state, obs = shard_batch((state, out.observations), mesh)
    ts = TrainState(state, obs, policy.initial_state((obs.shape[0], num_agents)), action_gen)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        perm, maps = (torch.from_numpy(x).to(device) for x in fed_draws(rng, E, num_agents, POOL))
        ts, metrics = train_step(ts, perm=perm, reset_maps=maps)
        losses.append(float(metrics["loss"]))
        if not np.isfinite(losses[-1]):
            raise RuntimeError(f"non-finite loss from the sharded train step: {losses[-1]}")
    return tuple(losses)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(world: int, args: list[str], timeout: float = 900) -> list[subprocess.CompletedProcess]:
    """Runs ``python -m mettagrid_tpu_torch.parallel.rig <rank> <world>
    <port> *args`` for every rank at once from the repository's root, on a
    free port; returns each rank's result (stdout and stderr together).
    Kills every rank if one outlives ``timeout`` seconds, and raises."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "mettagrid_tpu_torch.parallel.rig", str(r), str(world),
                               str(port), *args], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [subprocess.CompletedProcess(p.args, p.returncode, out) for p, out in zip(procs, outs)]


def dryrun_multichip(n_devices: int, device=None, backend: str | None = None) -> list[str]:
    """Spawns n_devices rank processes of the rig on ``device`` (CUDA unless
    "cpu"; raises without a card) over ``backend`` (NCCL on CUDA and Gloo
    on the CPU unless named; Gloo on CUDA lets ranks share a card), and
    raises unless every rank exits 0 and prints ``RIG_OK rank=<r>``. Returns
    each rank's output."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    results = spawn_ranks(n_devices, ["--device", dev.type, "--backend", backend])
    for r, res in enumerate(results):
        if res.returncode != 0 or f"RIG_OK rank={r}" not in res.stdout:
            raise RuntimeError(f"dryrun rank {r} failed (exit {res.returncode}):\n{res.stdout[-4000:]}")
    return [res.stdout for res in results]
