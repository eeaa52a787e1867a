"""Decode token observations into per-cell semantic features
(reference: sdk/agent/runtime/observation.py).

Reassembles multi-part features (`inv:x`, `inv:x:p1`, … base^part encoding —
systems/observation_encoder.hpp:198-225), resolves tag tokens to tag names,
and groups everything by window cell with ego-relative coordinates.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

from mettagrid_tpu_torch.policy.policy_env_interface import PolicyEnvInterface
from mettagrid_tpu_torch.simulator.interface import AgentObservation, Location

_PART_SUFFIX_RE = re.compile(r"^(?P<name>.+):p(?P<part>\d+)$")


@dataclass(slots=True)
class ObservationEnvelope:
    raw_observation: AgentObservation
    policy_env_info: PolicyEnvInterface
    step: Optional[int] = None


@dataclass(slots=True)
class ObservationCell:
    location: Location
    center: Location
    tags: tuple[str, ...]
    features: dict[str, int]

    @property
    def row(self) -> int:
        return self.location.r

    @property
    def col(self) -> int:
        return self.location.c

    @property
    def x(self) -> int:
        return self.location.c - self.center.c

    @property
    def y(self) -> int:
        return self.location.r - self.center.r


@dataclass(slots=True)
class DecodedObservation:
    observation: AgentObservation
    policy_env_info: PolicyEnvInterface
    step: Optional[int]
    center_row: int
    center_col: int
    cells_by_location: dict[tuple[int, int], ObservationCell]
    global_features: dict[str, int]

    @property
    def cells(self) -> list[ObservationCell]:
        return [self.cells_by_location[loc] for loc in sorted(self.cells_by_location)]

    @property
    def self_cell(self) -> ObservationCell:
        key = (self.center_row, self.center_col)
        if key not in self.cells_by_location:
            self.cells_by_location[key] = ObservationCell(
                location=Location(self.center_row, self.center_col),
                center=Location(self.center_row, self.center_col),
                tags=tuple(),
                features={},
            )
        return self.cells_by_location[key]


def _split_feature_name(feature_name: str) -> tuple[str, int]:
    m = _PART_SUFFIX_RE.match(feature_name)
    if m is None:
        return feature_name, 0
    return m.group("name"), int(m.group("part"))


def _decode_parts(parts: dict[int, int], base: int) -> int:
    return sum(value * (base**part) for part, value in parts.items())


def decode_observation(envelope: ObservationEnvelope) -> DecodedObservation:
    info = envelope.policy_env_info
    norm_by_name = {f.name: max(int(f.normalization), 1) for f in info.obs_features}

    tags_by_loc: defaultdict[tuple[int, int], list[str]] = defaultdict(list)
    parts_by_loc: defaultdict[tuple[int, int], dict[str, dict[int, int]]] = defaultdict(
        lambda: defaultdict(dict)
    )
    global_parts: defaultdict[str, dict[int, int]] = defaultdict(dict)
    bases: dict[str, int] = {}

    for token in envelope.raw_observation.tokens:
        if token.feature_name == "tag":
            loc = token.location
            if loc is not None:
                tags_by_loc[(loc.r, loc.c)].append(info.tags[token.value])
            continue
        name, part = _split_feature_name(token.feature_name)
        bases[name] = norm_by_name.get(token.feature_name, 1)
        if token.is_global:
            global_parts[name][part] = token.value
            continue
        loc = token.location
        if loc is not None:
            parts_by_loc[(loc.r, loc.c)][name][part] = token.value

    center_row = info.egocentric_shape[0] // 2
    center_col = info.egocentric_shape[1] // 2
    center = Location(center_row, center_col)
    cells: dict[tuple[int, int], ObservationCell] = {}
    for (r, c) in sorted(set(tags_by_loc) | set(parts_by_loc)):
        cells[(r, c)] = ObservationCell(
            location=Location(r, c),
            center=center,
            tags=tuple(sorted(tags_by_loc[(r, c)])),
            features={
                name: _decode_parts(parts, bases[name])
                for name, parts in parts_by_loc[(r, c)].items()
            },
        )
    return DecodedObservation(
        observation=envelope.raw_observation,
        policy_env_info=info,
        step=envelope.step,
        center_row=center_row,
        center_col=center_col,
        cells_by_location=cells,
        global_features={
            name: _decode_parts(parts, bases[name]) for name, parts in global_parts.items()
        },
    )
