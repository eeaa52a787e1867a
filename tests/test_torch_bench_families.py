"""The bench's cells built from the arena families (tools/bench_run.py's
tithe_rrng and full_combat, from parity/arena.py) are pinned: their configs
(model_dump(mode="json")), their pools of two maps (the tithe shrines renamed
from walls, the full-combat loadouts) and the full-combat script (8 steps of
24 agents from np.random.default_rng(7)) hash to what the bench's own copies
of the families produced before it was built from parity/arena.py, so the
cells that chip_smoke.py times do not move.
"""

import dataclasses
import hashlib
import json

import numpy as np
import pytest

from mettagrid_tpu_torch.tools import bench_run

PINS = {
    "tithe_rrng.cfg": "6301ad5a0a46ec2f71b143848a3225b3776cb4e79caa2fa9768b56e506d6ae50",
    "tithe_rrng.pool": "73fb423b0df7f85eb2ce4338e463d71fa2b2feaf841c11c787cb5581820cf5d9",
    "full_combat.cfg": "64baf9b2ba78394e75af12a8ffca8c8062b77acf5e84de136850c90400c8572a",
    "full_combat.pool": "43f30e050c661c71f0199dbb731c884152834ddfada46eff455bf87e9285e0c9",
    "full_combat.script": "4c2106809f3fc1caa0cbb9fb2c520f4e77ff8f640c96035d36e165bedc2c0839",
}


def _pool_hash(init) -> str:
    m = hashlib.sha256()
    for f in dataclasses.fields(init):
        val = getattr(init, f.name)
        m.update(f.name.encode())
        m.update(np.ascontiguousarray(val).tobytes() if isinstance(val, np.ndarray) else repr(val).encode())
    return m.hexdigest()


@pytest.mark.parametrize("pin", sorted(PINS))
def test_bench_family_pinned(pin):
    variant, part = pin.split(".")
    cfg = bench_run.make_cfg(variant)
    if part == "cfg":
        got = hashlib.sha256(json.dumps(cfg.model_dump(mode="json"), sort_keys=True).encode()).hexdigest()
    elif part == "pool":
        got = _pool_hash(bench_run.build_pool(cfg, 2, loadouts=variant == "full_combat")[1])
    else:
        program, _ = bench_run.build_pool(cfg, 1)
        acts, vibes = bench_run.full_combat_script(program, np.random.default_rng(7), (8, 24))
        got = hashlib.sha256(acts.tobytes() + vibes.tobytes()).hexdigest()
    assert got == PINS[pin]
