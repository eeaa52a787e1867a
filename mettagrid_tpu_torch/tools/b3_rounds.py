"""Kernel B3 (obs_tail_dyn_v2) at 12, 16 and 23 candidate rounds, on seeded
synthetic inputs at the arena_128 image size.

    PYTHONPATH=<checkout> python <checkout>/mettagrid_tpu_torch/tools/b3_rounds.py [--envs E] [--out PATH]

Makes, from --seed with numpy, E per-env images int32[E, 144, 512] (four
words in ten valid) and 24 agents per env with 3 global words and an 11x11
window each, four in five inside the image and the rest anywhere, crossing
its edges; then for S = 3, 4 and 6 token slots per cell (366, 487 and 729
candidates: 12, 16 and 23 rounds of 32) calls the wrapper ``obs_tail_dyn_v2``
at out_w = 256 (normal packing), holds its words and counts equal to the
plain version ``obs_tail_dyn_v2_ref`` and times it by CUDA events (the mean
of 100 calls after one warm-up). It uses only the wrapper's call, so run by
path with another checkout first on PYTHONPATH it times that checkout's B3
on the same inputs. Prints one JSON line per S (with the launch's plan where
the wrapper keeps one) and writes the list to --out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from mettagrid_tpu_torch.engine.kernels import obs_tail_dyn_v2 as b3

HP, WPC, A, G, OH, OUT_W = 144, 512, 24, 3, 11, 256
SLOTS = (3, 4, 6)


def _geom(device):
    """(u, v, loc) of the OH x OH window cells in Manhattan order from the
    centre, loc = u << 4 | v."""
    r = OH // 2
    cells = sorted(((u, v) for u in range(OH) for v in range(OH)), key=lambda c: (abs(c[0] - r) + abs(c[1] - r), c))
    return torch.tensor([[u, v, (u << 4) | v] for u, v in cells], dtype=torch.int32, device=device)


def _time_ms(fn, reps: int = 100) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(E: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    img = np.where(rng.random((E, HP, WPC)) < 0.4, rng.integers(1, 1 << 16, (E, HP, WPC)), 0).astype(np.int32)
    imgp = torch.from_numpy(img).cuda()
    del img
    gplus = torch.from_numpy(rng.integers(0, 1 << 16, (E, A, G)).astype(np.int32)).cuda()
    geom = _geom("cuda")
    rows = []
    for S in SLOTS:
        r0 = rng.integers(0, HP - OH + 1, (E, A))
        l0 = rng.integers(0, (WPC - OH * S) // S + 1, (E, A)) * S
        anywhere = rng.random((E, A)) < 0.2
        r0 = np.where(anywhere, rng.integers(-OH + 1, HP, (E, A)), r0)
        l0 = np.where(anywhere, rng.integers(-OH + 1, WPC // S, (E, A)) * S, l0)
        args = dict(imgp=imgp, row0=torch.from_numpy(r0.astype(np.int32)).cuda(),
                    lane0=torch.from_numpy(l0.astype(np.int32)).cuda(), gplus=gplus, geom=geom, S=S, out_w=OUT_W)
        words, att = b3.obs_tail_dyn_v2(**args)
        ref_words, ref_att = b3.obs_tail_dyn_v2_ref(**args)
        torch.cuda.synchronize()
        assert torch.equal(words, ref_words) and torch.equal(att, ref_att), f"B3 differs from its plain version at S {S}"
        del words, att, ref_words, ref_att
        ms = _time_ms(lambda: b3.obs_tail_dyn_v2(**args))
        row = dict(kernel="B3", E=E, image=[HP, WPC], S=S, candidates=G + OH * OH * S,
                   rounds_needed=-(-(G + OH * OH * S) // 32), out_w=OUT_W, ms=ms,
                   plan=getattr(b3.obs_tail_dyn_v2, "last_launch", None))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("b3_rounds needs a CUDA device")
    rows = run(args.envs, args.seed)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
