"""Connect disconnected walkable regions by carving corridors
(reference: mapgen/scenes/make_connected.py)."""

from __future__ import annotations

import numpy as np

from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig


class MakeConnectedConfig(SceneConfig):
    pass


def _label_components(walkable: np.ndarray) -> tuple[np.ndarray, int]:
    """4-connected component labeling via BFS (no scipy dependency)."""
    H, W = walkable.shape
    labels = np.full((H, W), -1, dtype=np.int32)
    n = 0
    for sy in range(H):
        for sx in range(W):
            if not walkable[sy, sx] or labels[sy, sx] >= 0:
                continue
            stack = [(sy, sx)]
            labels[sy, sx] = n
            while stack:
                y, x = stack.pop()
                for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    ny, nx = y + dy, x + dx
                    if 0 <= ny < H and 0 <= nx < W and walkable[ny, nx] and labels[ny, nx] < 0:
                        labels[ny, nx] = n
                        stack.append((ny, nx))
            n += 1
    return labels, n


class MakeConnected(Scene[MakeConnectedConfig]):
    """Carve minimal L-corridors until every non-wall region is connected."""

    def render(self) -> None:
        while True:
            walkable = self.grid != "wall"
            labels, n = _label_components(walkable)
            if n <= 1:
                return
            # Connect component 0 to the nearest cell of any other component.
            ys0, xs0 = np.nonzero(labels == 0)
            yso, xso = np.nonzero((labels > 0))
            d = np.abs(ys0[:, None] - yso[None, :]) + np.abs(xs0[:, None] - xso[None, :])
            i, j = np.unravel_index(np.argmin(d), d.shape)
            y1, x1 = int(ys0[i]), int(xs0[i])
            y2, x2 = int(yso[j]), int(xso[j])
            carve = self.grid
            lo, hi = min(x1, x2), max(x1, x2)
            carve[y1, lo : hi + 1] = np.where(
                carve[y1, lo : hi + 1] == "wall", "empty", carve[y1, lo : hi + 1]
            )
            lo, hi = min(y1, y2), max(y1, y2)
            carve[lo : hi + 1, x2] = np.where(
                carve[lo : hi + 1, x2] == "wall", "empty", carve[lo : hi + 1, x2]
            )
