"""Binary pattern utilities for texture-synthesis scenes (ConvChain, WFC).

Samples are ASCII art: '#' = True (wall), anything else False. Both
algorithms (Gumin's ConvChain / WaveFunctionCollapse, public MIT projects)
are re-implemented here from their published descriptions.
"""

from __future__ import annotations

from typing import Literal

import numpy as np

Symmetry = Literal["none", "horizontal", "all"]


def parse_ascii_sample(pattern: str) -> np.ndarray:
    lines = [line for line in pattern.splitlines() if line.strip()]
    width = max(len(line) for line in lines)
    return np.array(
        [[ch == "#" for ch in line.ljust(width)] for line in lines], dtype=bool
    )


def symmetry_variants(field: np.ndarray, symmetry: Symmetry) -> list[np.ndarray]:
    if symmetry == "none":
        return [field]
    if symmetry == "horizontal":
        return [field, np.fliplr(field)]
    out = []
    cur = field
    for _ in range(4):
        out.append(cur)
        out.append(np.fliplr(cur))
        cur = np.rot90(cur)
    return out


def _pattern_index(window: np.ndarray) -> int:
    bits = window.ravel()
    idx = 0
    for b in bits:
        idx = (idx << 1) | int(b)
    return idx


def extract_pattern_weights(sample: np.ndarray, n: int, symmetry: Symmetry, periodic: bool) -> np.ndarray:
    """weights[2^(n*n)] — occurrence counts of every n x n binary window."""
    weights = np.zeros(1 << (n * n), dtype=np.float64)
    for variant in symmetry_variants(sample, symmetry):
        H, W = variant.shape
        if periodic:
            padded = np.pad(variant, ((0, n - 1), (0, n - 1)), mode="wrap")
            ys, xs = H, W
        else:
            padded = variant
            ys, xs = H - n + 1, W - n + 1
        for y in range(ys):
            for x in range(xs):
                weights[_pattern_index(padded[y : y + n, x : x + n])] += 1
    return weights


def extract_patterns_with_counts(
    sample: np.ndarray, n: int, symmetry: Symmetry, periodic: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Distinct n x n patterns (as bool arrays) with occurrence counts."""
    counts: dict[bytes, int] = {}
    shapes: dict[bytes, np.ndarray] = {}
    for variant in symmetry_variants(sample, symmetry):
        H, W = variant.shape
        if periodic:
            padded = np.pad(variant, ((0, n - 1), (0, n - 1)), mode="wrap")
            ys, xs = H, W
        else:
            padded = variant
            ys, xs = H - n + 1, W - n + 1
        for y in range(ys):
            for x in range(xs):
                win = padded[y : y + n, x : x + n]
                key = win.tobytes()
                counts[key] = counts.get(key, 0) + 1
                shapes[key] = win.copy()
    pats = np.stack([shapes[k] for k in counts])
    cnts = np.array([counts[k] for k in counts], dtype=np.float64)
    return pats, cnts
