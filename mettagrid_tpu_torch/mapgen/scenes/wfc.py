"""Wave Function Collapse, overlapping binary model
(reference: mapgen/scenes/wfc.py — both trace to Gumin's published WFC; this
is an independent implementation: pattern extraction with counts, adjacency
compatibility, min-entropy observation, BFS constraint propagation, restart
on contradiction)."""

from __future__ import annotations

from collections import deque

import numpy as np
from pydantic import Field

from mettagrid_tpu_torch.mapgen.pattern import Symmetry, extract_patterns_with_counts, parse_ascii_sample
from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig

_DY = (-1, 0, 1, 0)
_DX = (0, 1, 0, -1)


class WFCConfig(SceneConfig):
    pattern: str = Field(description="ASCII sample ('#' = wall)")
    pattern_size: int = 3
    periodic_input: bool = True
    symmetry: Symmetry = "all"
    attempts: int = 8
    on_value: str = "wall"
    off_value: str = "empty"


class WFC(Scene[WFCConfig]):
    def render(self) -> None:
        cfg = self.config
        n = cfg.pattern_size
        sample = parse_ascii_sample(cfg.pattern)
        pats, counts = extract_patterns_with_counts(sample, n, cfg.symmetry, cfg.periodic_input)
        P = len(pats)
        weights = counts / counts.sum()

        # compat[d][p] = bool mask over q: q may sit one step in direction d
        # from p (overlapping regions agree)
        compat = np.zeros((4, P, P), dtype=bool)
        for d in range(4):
            dy, dx = _DY[d], _DX[d]
            for p in range(P):
                a = pats[p]
                for q in range(P):
                    b = pats[q]
                    ya0, ya1 = max(0, dy), min(n, n + dy)
                    xa0, xa1 = max(0, dx), min(n, n + dx)
                    yb0, yb1 = max(0, -dy), min(n, n - dy)
                    xb0, xb1 = max(0, -dx), min(n, n - dx)
                    compat[d, p, q] = np.array_equal(a[ya0:ya1, xa0:xa1], b[yb0:yb1, xb0:xb1])

        GH = max(self.height - n + 1, 1)
        GW = max(self.width - n + 1, 1)

        for _attempt in range(cfg.attempts):
            field = self._collapse(GH, GW, P, weights, compat)
            if field is not None:
                break
        else:
            # fall back to pure noise biased by pattern density
            density = float((pats[:, 0, 0] * weights).sum())
            noise = self.rng.random((self.height, self.width)) < density
            self.grid[noise] = cfg.on_value
            self.grid[~noise] = cfg.off_value
            return

        out = np.zeros((self.height, self.width), dtype=bool)
        for y in range(GH):
            for x in range(GW):
                out[y, x] = pats[field[y, x], 0, 0]
        # finish the right/bottom border from the last row/col patterns
        for y in range(GH):
            out[y, GW - 1 : GW - 1 + n] = pats[field[y, GW - 1]][0][: self.width - GW + 1]
        for x in range(GW):
            out[GH - 1 : GH - 1 + n, x] = pats[field[GH - 1, x]][: self.height - GH + 1, 0]
        self.grid[out] = cfg.on_value
        self.grid[~out] = cfg.off_value

    def _collapse(self, GH, GW, P, weights, compat):
        possible = np.ones((GH, GW, P), dtype=bool)

        def propagate(sy, sx):
            queue = deque([(sy, sx)])
            while queue:
                y, x = queue.popleft()
                mask = possible[y, x]
                for d in range(4):
                    ny, nx = y + _DY[d], x + _DX[d]
                    if not (0 <= ny < GH and 0 <= nx < GW):
                        continue
                    allowed = compat[d][mask].any(axis=0)  # union of neighbors allowed
                    new = possible[ny, nx] & allowed
                    if not new.any():
                        raise _Contradiction
                    if (new != possible[ny, nx]).any():
                        possible[ny, nx] = new
                        queue.append((ny, nx))

        try:
            for _ in range(GH * GW):
                counts = possible.sum(axis=-1)
                undecided = counts > 1
                if not undecided.any():
                    break
                # min-entropy cell (with tiny noise for tie-breaking)
                ent = np.where(undecided, counts.astype(np.float64), np.inf)
                ent = ent + self.rng.random(ent.shape) * 0.1
                y, x = np.unravel_index(np.argmin(ent), ent.shape)
                opts = np.flatnonzero(possible[y, x])
                w = weights[opts] / weights[opts].sum()
                choice = self.rng.choice(opts, p=w)
                possible[y, x] = False
                possible[y, x, choice] = True
                propagate(y, x)
        except _Contradiction:
            return None

        return possible.argmax(axis=-1)


class _Contradiction(Exception):
    pass
