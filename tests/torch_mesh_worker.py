"""One rank of the port's mesh helpers on the CPU, for tests/test_torch_parallel.py.

    python -m tests.torch_mesh_worker RANK WORLD PORT MODEL_PARALLEL OUT_PREFIX

Forms a Gloo group of WORLD ranks over tcp://127.0.0.1:PORT, a
("data", "model") mesh with MODEL_PARALLEL, and writes OUT_PREFIX<rank>.npz
with what this rank holds: its mesh indices, its shard of a seeded full
batch (an int32 tensor, a bool tensor, a float numpy array and an
LSTMState), that shard gathered back, the flat parameters of an LSTMPolicy
seeded by rank after ``replicate``, a replicated tree, and the error that
``shard_batch`` raised for 6 envs on a mesh of WORLD data ranks. The test
asserts on them.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from mettagrid_tpu_torch.parallel import gather_batch, make_mesh, replicate, shard_batch
from mettagrid_tpu_torch.policy import LSTMPolicy, LSTMState

E = 8


def full_batch():
    rng = np.random.default_rng(7)
    return (torch.from_numpy(rng.integers(0, 100, (E, 3)).astype(np.int32)), torch.from_numpy(rng.random(E) < 0.5),
            rng.standard_normal((E, 2)).astype(np.float32),
            LSTMState(torch.from_numpy(rng.standard_normal((E, 2, 4)).astype(np.float32)),
                      torch.from_numpy(rng.standard_normal((E, 2, 4)).astype(np.float32))))


def main(rank: int, world: int, port: int, model_parallel: int, prefix: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        mesh = make_mesh(world, model_parallel, "cpu")
        ints, bools, floats, lstm = shard_batch(full_batch(), mesh)
        g_ints, g_bools, g_floats, g_lstm = gather_batch((ints, bools, floats, lstm), mesh)
        gen = torch.Generator()
        gen.manual_seed(100 + rank)
        policy = replicate(LSTMPolicy(5, 8, 8, device="cpu", generator=gen), mesh)
        tree = replicate({"w": np.full(3, rank, np.float32), "b": torch.tensor([rank % 2 == 1])}, mesh)
        try:
            shard_batch(np.zeros((6, 2)), make_mesh(world, 1, "cpu"))
            refused = ""
        except ValueError as exc:
            refused = str(exc)
        np.savez(f"{prefix}{rank}.npz", data=mesh.get_local_rank("data"), model=mesh.get_local_rank("model"),
                 ints=ints.numpy(), bools=bools.numpy(), floats=floats.numpy(), h=lstm.h.numpy(), c=lstm.c.numpy(),
                 g_ints=g_ints.numpy(), g_bools=g_bools.numpy(), g_floats=g_floats.numpy(), g_h=g_lstm.h.numpy(),
                 g_c=g_lstm.c.numpy(), params=torch.cat([p.detach().reshape(-1) for p in policy.parameters()]).numpy(),
                 tree_w=tree["w"].numpy(), tree_b=tree["b"].numpy(), refused=refused)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*map(int, sys.argv[1:5]), sys.argv[5])
