"""Seeded inputs of the benchmark: the rating matrices and the model tensors."""

MASK64 = (1 << 64) - 1


def derive_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of the run seeded with ``seed``
    (splitmix64), so that the data, the weights and the traffic draw from
    streams of their own; any non-negative whole ``seed`` works."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (stream + 1) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) >> 1
