"""Search-space dimensions.

A copy of ganmf_tpu/tune/space.py, which imports nothing of JAX: the subset of
skopt's dimensions that the reference harness uses (RecSysExp.py:444-549),
Real (uniform or log-uniform), Integer and Categorical. Each dimension maps
to and from the unit cube for the GP surrogate.
"""

from __future__ import annotations

import math
from typing import Any, List, Sequence

import numpy as np


class Dimension:
    name: str

    def sample(self, rng: np.random.RandomState):
        return self.from_unit(rng.rand())

    def to_unit(self, value) -> float:
        raise NotImplementedError

    def from_unit(self, u: float):
        raise NotImplementedError


class Real(Dimension):
    def __init__(self, low, high, prior: str = "uniform", name: str = None, dtype=float):
        assert high > low
        self.low, self.high = float(low), float(high)
        self.prior = prior
        self.name = name
        if prior == "log-uniform":
            assert low > 0

    @property
    def bounds(self):
        return (self.low, self.high)

    def to_unit(self, value) -> float:
        if self.prior == "log-uniform":
            return (math.log(value) - math.log(self.low)) / (math.log(self.high) - math.log(self.low))
        return (value - self.low) / (self.high - self.low)

    def from_unit(self, u: float):
        u = min(max(u, 0.0), 1.0)
        if self.prior == "log-uniform":
            return float(math.exp(math.log(self.low) + u * (math.log(self.high) - math.log(self.low))))
        return float(self.low + u * (self.high - self.low))


class Integer(Dimension):
    def __init__(self, low, high, prior: str = "uniform", name: str = None, dtype=int):
        assert high >= low
        self.low, self.high = int(low), int(high)
        self.name = name
        self.prior = prior

    @property
    def bounds(self):
        return (self.low, self.high)

    def to_unit(self, value) -> float:
        if self.high == self.low:
            return 0.5
        return (value - self.low) / (self.high - self.low)

    def from_unit(self, u: float):
        u = min(max(u, 0.0), 1.0)
        return int(round(self.low + u * (self.high - self.low)))


class Categorical(Dimension):
    def __init__(self, categories: Sequence[Any], name: str = None):
        self.categories = list(categories)
        self.name = name

    @property
    def bounds(self):
        return tuple(self.categories)

    def to_unit(self, value) -> float:
        idx = self.categories.index(value)
        if len(self.categories) == 1:
            return 0.5
        return idx / (len(self.categories) - 1)

    def from_unit(self, u: float):
        u = min(max(u, 0.0), 1.0)
        idx = int(round(u * (len(self.categories) - 1)))
        return self.categories[idx]


def encode_point(dimensions: List[Dimension], x: Sequence) -> np.ndarray:
    return np.array([d.to_unit(v) for d, v in zip(dimensions, x)], dtype=np.float64)


def decode_point(dimensions: List[Dimension], u: np.ndarray) -> list:
    return [d.from_unit(v) for d, v in zip(dimensions, u)]
