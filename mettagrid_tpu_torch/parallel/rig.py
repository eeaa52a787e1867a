"""The multi-process rig (reference: scripts/multiproc_rig.py).

    python -m mettagrid_tpu_torch.parallel.rig RANK WORLD PORT [--envs E] [--agents A] [--steps S]
        [--model-parallel M] [--device cuda|cpu] [--backend nccl|gloo] [--replay IN.npz] [--out OUT.npz]

Every rank runs it with its own RANK; the ranks form one process group over
tcp://127.0.0.1:PORT and a ("data", "model") mesh (parallel/mesh.py). It
asserts, as the reference's rig does:

1. engine parity across processes: the dryrun arena's E envs (2 per rank by
   default), stepped 12 times sharded over "data" and, in each rank, as one
   full batch, with the same seeded actions, agent orders and reset maps;
   every state field, the observations and the rewards gathered from the
   ranks equal the full batch's bit for bit, and every output of the
   sharded step holds this rank's rows on its device;
2. the sharded trainer: ``train_losses_multichip`` for S steps (2 by
   default), printed as ``RIG_LOSSES <hex> ...`` (float.hex).

With ``--replay IN.npz`` it runs neither, and replays instead the training
run that ``write_replay`` saved: the start state and observations, the
flax parameters, the optimizer, and every step's actions, agent orders and
reset maps, all over the global batch. Rank 0 writes OUT.npz
(``read_result``): each step's metrics, parameters and gradients in flax
layout, the final state, observations and LSTM state gathered over
"data", every rank's flat parameters, and each rank's launches of the
observation kernel and peak device memory. Without --replay, --out saves
part 1's gathered state, observations and rewards and part 2's losses.

Each rank prints ``RIG_OK rank=<r>`` at the end; a failed check or a
backend that does not come up fails its process. ``--device`` defaults to
CUDA and raises without a card; the backend defaults to NCCL on CUDA and
Gloo on the CPU.
"""

from __future__ import annotations

import argparse
import datetime

import numpy as np
import torch
import torch.distributed as dist

from mettagrid_tpu_torch.engine.interop import state_from_numpy, state_to_numpy
from mettagrid_tpu_torch.engine.state import EnvState, StepOutputs, resolve_device
from mettagrid_tpu_torch.parallel.dryrun import POOL, build_env, fed_draws, train_losses_multichip
from mettagrid_tpu_torch.parallel.mesh import data_rows, gather_batch, make_mesh, rank_device, replicate, shard_batch
from mettagrid_tpu_torch.parallel.train import TrainState, adam, make_train_step, trainable_parameters
from mettagrid_tpu_torch.policy import LSTMPolicy, params_from_flax, params_to_flax
from mettagrid_tpu_torch.policy.interop import _to_flax

PARITY_STEPS = 12


def _flat(tree: dict, prefix: str, out: dict) -> dict:
    """A nested dict of arrays as npz keys ``prefix/a/b``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _tree(arrays, prefix: str) -> dict:
    """The nested dict that ``_flat`` saved under ``prefix``."""
    tree: dict = {}
    for key in arrays:
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = arrays[key]
    return tree


def write_replay(path, *, state: dict, obs, params: dict, actions, perm, reset_maps, optimizer: str, lr: float,
                 variant: str = "arena") -> None:
    """Saves a training run for ``--replay``: the start ``state`` (a dict of
    numpy arrays per EnvState field) and observations of the global batch,
    the flax parameters, and per step the actions int32[S, E, A], agent
    orders int32[S, E, A] and reset maps int32[S, E]; ``optimizer`` is
    "sgd" or "adam" with learning rate ``lr``; ``variant`` names the env
    (dryrun.build_env)."""
    arrays = _flat(state, "state", {})
    _flat(params, "params", arrays)
    np.savez(path, obs=np.asarray(obs), actions=np.asarray(actions, np.int32), perm=np.asarray(perm, np.int32),
             reset_maps=np.asarray(reset_maps, np.int32), optimizer=optimizer, lr=lr, variant=variant, **arrays)


def read_result(path) -> dict:
    """OUT.npz of a replay as nested dicts: ``steps`` (per step: loss,
    entropy, reward_mean, params, grads), ``state``, ``obs``, ``lstm_h``,
    ``lstm_c``, ``rank_params`` float32[world, P], ``rank_launches``
    int64[world] and ``rank_peak_bytes`` int64[world] (peak device memory
    on CUDA, else 0); of a run without --replay, ``state``, ``obs``,
    ``rewards``, ``losses`` and ``rank_rows`` (engine_parity)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    out = {k: v for k, v in arrays.items() if "/" not in k}
    out["state"] = _tree(arrays, "state")
    n = int(arrays["n_steps"]) if "n_steps" in arrays else 0
    out["steps"] = [dict(_tree(arrays, f"step{s}"), **{m: float(arrays[f"{m}{s}"]) for m in
                                                        ("loss", "entropy", "reward_mean")}) for s in range(n)]
    return out


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def _own(result: tuple) -> tuple:
    """A step's (state, outputs), copied out of the step's buffers (on the
    CUDA graph path they are rewritten by its next call, engine/step.py)."""
    state, out = result
    return EnvState(*(t.clone() for t in state)), StepOutputs(*(t.clone() for t in out))


def engine_parity(mesh, num_envs: int, num_agents: int):
    """Part 1; returns the gathered state, observations and rewards, and
    int64[world, 3]: each rank's first and past-last row and its sharded
    observations' rows. One step function runs both batches in turns, so
    each keeps a copy of its state across the other's step."""
    device = rank_device(mesh)
    program, reset, step = build_env(num_agents, num_envs, device)
    full, out_full = reset(0)
    state = shard_batch(full, mesh)
    rows = data_rows(mesh, num_envs)
    rng = np.random.default_rng(0)
    n = len(program.action_names)
    for _ in range(PARITY_STEPS):
        acts = rng.integers(0, n, (num_envs, num_agents)).astype(np.int32)
        perm, maps = fed_draws(rng, num_envs, num_agents, POOL)
        vibes = np.zeros_like(acts)
        g = [torch.from_numpy(x).to(device) for x in (acts, vibes, perm)]
        full, out_full = _own(step(full, *g, reset_maps=torch.from_numpy(maps).to(device)))
        state, out = _own(step(state, *shard_batch([acts, vibes, perm], mesh), reset_maps=shard_batch(maps, mesh)))
    for name, x in list(state._asdict().items()) + list(out._asdict().items()):
        _require(x.shape[0] == rows.stop - rows.start and x.device == device,
                 f"the sharded step's {name} is {tuple(x.shape)} on {x.device}, not this rank's rows on {device}")
    state_g, obs_g, rewards_g = gather_batch((state, out.observations, out.rewards), mesh)
    for name in EnvState._fields:
        _require(torch.equal(getattr(state_g, name), getattr(full, name)), f"state field {name} diverged across ranks")
    _require(torch.equal(obs_g, out_full.observations), "observations diverged across ranks")
    _require(torch.equal(rewards_g, out_full.rewards), "rewards diverged across ranks")
    held = torch.tensor([rows.start, rows.stop, out.observations.shape[0]], device=device)
    every = [torch.empty_like(held) for _ in range(dist.get_world_size())]
    dist.all_gather(every, held)
    return state_g, obs_g, rewards_g, torch.stack(every)


def replay(mesh, path_in, path_out) -> None:
    """Part 3: the replayed training run; rank 0 writes ``path_out``."""
    device = rank_device(mesh)
    with np.load(path_in) as z:
        data = {k: z[k] for k in z.files}
    actions = data["actions"]
    S, E, A = actions.shape
    program, _, step = build_env(A, E, device, str(data["variant"]))
    pre = _tree(data, "params")["params"]["pre"]["kernel"]
    policy = LSTMPolicy(len(program.action_names), pre.shape[1], pre.shape[0], device=device)
    policy = replicate(params_from_flax(policy, _tree(data, "params")), mesh)
    lr = float(data["lr"])
    optimizer = (adam(policy, lr) if str(data["optimizer"]) == "adam"
                 else torch.optim.SGD(trainable_parameters(policy), lr=lr))
    train_step = make_train_step(program, step, policy, optimizer, mesh=mesh)
    state, obs = shard_batch((state_from_numpy(_tree(data, "state"), "cpu"), data["obs"]), mesh)
    ts = TrainState(state, obs, policy.initial_state((obs.shape[0], A)), torch.Generator(device=device))
    kernel = step.obs_fn.tail
    launches = kernel.launches
    result = {"n_steps": S}
    for s in range(S):
        acts, perm, maps = (torch.from_numpy(x[s]).to(device) for x in (actions, data["perm"], data["reset_maps"]))
        ts, metrics = train_step(ts, actions=acts, perm=perm, reset_maps=maps)
        for m, v in metrics.items():
            result[f"{m}{s}"] = float(v)
        _flat(params_to_flax(policy), f"step{s}/params", result)
        _flat({"params": _to_flax(policy, lambda p: torch.zeros_like(p) if p.grad is None else p.grad)},
              f"step{s}/grads", result)
    state_g, obs_g, lstm_g = gather_batch((ts.env_state, ts.obs, ts.lstm_state), mesh)
    flat = torch.cat([p.detach().reshape(-1) for p in policy.parameters()])
    every = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(every, flat)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counts = torch.tensor([kernel.launches - launches, peak], device=device)
    all_counts = [torch.empty_like(counts) for _ in range(dist.get_world_size())]
    dist.all_gather(all_counts, counts)
    all_counts = torch.stack(all_counts).cpu().numpy()
    if dist.get_rank() == 0:
        _flat(state_to_numpy(state_g), "state", result)
        np.savez(path_out, obs=obs_g.cpu().numpy(), lstm_h=lstm_g.h.cpu().numpy(), lstm_c=lstm_g.c.cpu().numpy(),
                 rank_params=torch.stack(every).cpu().numpy(), rank_launches=all_counts[:, 0],
                 rank_peak_bytes=all_counts[:, 1], **result)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The multi-process rig of the port's mesh and sharded trainer.")
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--envs", type=int, default=None, help="global envs (default 2 per rank)")
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2, help="train steps of part 2")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, help="nccl (default on cuda) or gloo")
    ap.add_argument("--replay", default=None, help="a run saved by write_replay")
    ap.add_argument("--out", default=None, help="where rank 0 writes its results")
    args = ap.parse_args(argv)
    if args.replay and not args.out:
        ap.error("--replay needs --out")
    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{args.port}", world_size=args.world,
                            rank=args.rank, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(args.world, args.model_parallel, device)
        if args.replay:
            replay(mesh, args.replay, args.out)
        else:
            E = 2 * args.world if args.envs is None else args.envs
            state, obs, rewards, held = engine_parity(mesh, E, args.agents)
            losses = train_losses_multichip(mesh, E, args.agents, args.steps)
            print("RIG_LOSSES " + " ".join(x.hex() for x in losses), flush=True)
            if args.out and args.rank == 0:
                np.savez(args.out, obs=obs.cpu().numpy(), rewards=rewards.cpu().numpy(), losses=np.array(losses),
                         rank_rows=held.cpu().numpy(), **_flat(state_to_numpy(state), "state", {}))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"RIG_OK rank={args.rank}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
