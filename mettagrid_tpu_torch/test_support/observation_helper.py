"""Token-observation inspection helpers
(reference: mettagrid_tpu/test_support/observation_helper.py)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

EMPTY = 0xFF
GLOBAL = 0xFE


class ObservationHelper:
    """Finds tokens in a raw (T, 3) uint8 observation."""

    def __init__(self, obs: np.ndarray, features=None):
        self.obs = np.asarray(obs)
        self._by_name = {f.name: f.id for f in features} if features else {}

    def tokens(self) -> List[tuple[int, int, int]]:
        return [tuple(int(x) for x in t) for t in self.obs if t[0] != EMPTY]

    def find_tokens(
        self,
        feature_id: Optional[int] = None,
        feature_name: Optional[str] = None,
        location: Optional[tuple[int, int]] = None,
    ) -> List[tuple[int, int, int]]:
        if feature_name is not None:
            feature_id = self._by_name[feature_name]
        out = []
        for loc, fid, val in self.tokens():
            if feature_id is not None and fid != feature_id:
                continue
            if location is not None:
                if loc == GLOBAL:
                    continue
                if ((loc >> 4) & 0x0F, loc & 0x0F) != location:
                    continue
            out.append((loc, fid, val))
        return out

    def global_tokens(self) -> List[tuple[int, int, int]]:
        return [t for t in self.tokens() if t[0] == GLOBAL]

    def value_at(self, feature_name: str, location: Optional[tuple[int, int]] = None) -> Optional[int]:
        found = self.find_tokens(feature_name=feature_name, location=location)
        return found[0][2] if found else None
