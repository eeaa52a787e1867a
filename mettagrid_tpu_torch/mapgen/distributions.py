"""Random value distributions for scene configs
(reference: python/src/mettagrid/mapgen/random/{int,float}.py).

Configs accept plain numbers (constant), ``("uniform", low, high)`` tuples, or
``("lognormal", p5, p95[, max])`` for floats; pydantic coerces them through the
annotated validators below.
"""

from __future__ import annotations

from typing import Annotated, Union

import numpy as np
from pydantic import BaseModel, BeforeValidator

# Seed-or-generator convenience type used by scene helpers.
MaybeSeed = Union[int, np.random.Generator, None]

# Inverse normal CDF at 0.95 — the 90%-interval z-score used by the lognormal
# parameterization (reference: mapgen/random/float.py, stats.norm.ppf).
_Z90 = 1.6448536269514722


class BaseIntDistribution(BaseModel):
    def sample(self, rng: np.random.Generator) -> int: ...


class IntConstantDistribution(BaseIntDistribution):
    value: int

    def sample(self, rng: np.random.Generator) -> int:
        return self.value


class IntUniformDistribution(BaseIntDistribution):
    low: int
    high: int

    def sample(self, rng: np.random.Generator) -> int:
        return int(rng.integers(self.low, self.high, endpoint=True))


def _to_int_distribution(v) -> BaseIntDistribution:
    if isinstance(v, BaseIntDistribution):
        return v
    if isinstance(v, int):
        return IntConstantDistribution(value=v)
    if isinstance(v, (list, tuple)) and len(v) == 3 and v[0] == "uniform":
        return IntUniformDistribution(low=v[1], high=v[2])
    raise TypeError("value must be an int or ('uniform', low, high) tuple")


IntDistribution = Annotated[BaseIntDistribution, BeforeValidator(_to_int_distribution)]


class BaseFloatDistribution(BaseModel):
    def sample(self, rng: np.random.Generator) -> float: ...


class FloatConstantDistribution(BaseFloatDistribution):
    value: float

    def sample(self, rng: np.random.Generator) -> float:
        return self.value


class FloatUniformDistribution(BaseFloatDistribution):
    low: float
    high: float

    def sample(self, rng: np.random.Generator) -> float:
        return float(rng.uniform(self.low, self.high))


class FloatLognormalDistribution(BaseFloatDistribution):
    """Lognormal with a 90% probability of landing in [low, high]."""

    low: float
    high: float
    max: float | None = None

    def sample(self, rng: np.random.Generator) -> float:
        if self.low >= self.high:
            raise ValueError("low must be less than high")
        if self.low <= 0:
            raise ValueError("low must be above 0")
        log_low, log_high = np.log(self.low), np.log(self.high)
        mu = (log_low + log_high) / 2
        sigma = (log_high - log_low) / (2 * _Z90)
        value = float(rng.lognormal(mean=mu, sigma=sigma))
        if self.max is not None:
            value = min(value, self.max)
        return value


def _to_float_distribution(v) -> BaseFloatDistribution:
    if isinstance(v, BaseFloatDistribution):
        return v
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return FloatConstantDistribution(value=float(v))
    if isinstance(v, (list, tuple)) and len(v) == 3 and v[0] == "uniform":
        return FloatUniformDistribution(low=v[1], high=v[2])
    if isinstance(v, (list, tuple)) and v and v[0] == "lognormal" and len(v) in (3, 4):
        return FloatLognormalDistribution(low=v[1], high=v[2], max=v[3] if len(v) == 4 else None)
    raise TypeError(
        "value must be a number, ('uniform', low, high), or ('lognormal', p5, p95[, max])"
    )


FloatDistribution = Annotated[BaseFloatDistribution, BeforeValidator(_to_float_distribution)]
