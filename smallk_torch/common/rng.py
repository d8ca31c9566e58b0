"""Random number generation of the port (a copy of smallk_tpu/common/rng.py).

The reference wraps std::mt19937 with uniform doubles in
[center - radius, center + radius] (reference: common/include/random.hpp:9-60)
and provides parallel per-thread-seeded dense initialization
(reference: common/include/matrix_generator.hpp:61-228).

Factor initializers (W: m x k, H: k x n) are tiny relative to A, so they
are generated host-side with NumPy's MT19937 (same generator family as the
reference) for cheap cross-backend determinism, then copied to the device
once.  The stream is the JAX package's bit for bit.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


class Random:
    """Mirror of the reference Random class (common/include/random.hpp)."""

    def __init__(self, seed: Optional[int] = None):
        self._seed = self._normalize_seed(seed)
        self._rs = np.random.RandomState(self._seed)

    @staticmethod
    def _normalize_seed(seed: Optional[int]) -> int:
        if seed is None:
            return int(time.time_ns() % (2**32))
        return int(seed) % (2**32)

    @property
    def seed(self) -> int:
        return self._seed

    def seed_from_time(self) -> int:
        self._seed = self._normalize_seed(None)
        self._rs = np.random.RandomState(self._seed)
        return self._seed

    def seed_from_int(self, seed: int) -> None:
        self._seed = self._normalize_seed(seed)
        self._rs = np.random.RandomState(self._seed)

    def double(self, center: float = 0.5, radius: float = 0.5) -> float:
        """Uniform double in [center - radius, center + radius)."""
        return float(center + radius * (2.0 * self._rs.random_sample() - 1.0))

    def uniform(
        self,
        shape,
        center: float = 0.5,
        radius: float = 0.5,
        dtype=np.float64,
    ) -> np.ndarray:
        """Uniform array in [center - radius, center + radius)."""
        u = self._rs.random_sample(size=shape)
        return (center + radius * (2.0 * u - 1.0)).astype(dtype)

    def choice(self, n: int, size: int, replace: bool = False) -> np.ndarray:
        """Sample indices from range(n), advancing the engine stream."""
        return self._rs.choice(n, size=size, replace=replace)

    def device_key_seed(self) -> int:
        """Draw a 31-bit seed from the stream for a device generator.

        Device-side initializer draws (hierclust's node solves seed a
        `torch.Generator` with it) are keyed from the host stream so runs
        stay deterministic under this class's seed and checkpointed state —
        the draw advances the MT19937 stream exactly like any other
        consumption."""
        return int(self._rs.randint(0, 2**31))

    def get_state(self):
        """RNG state accessor (reference Random::GetState, random.hpp:27)."""
        return self._rs.get_state()

    def set_state(self, state) -> None:
        self._rs.set_state(state)


def random_matrix(
    height: int,
    width: int,
    rng: Random,
    center: float = 0.5,
    radius: float = 0.5,
    dtype=np.float64,
) -> np.ndarray:
    """Dense random matrix in Fortran (column-major) fill order.

    The reference fills column-by-column (matrix_generator.hpp:61-95); we
    generate column-major so fixed seeds yield the same element sequence
    ordering convention as the reference.
    """
    flat = rng.uniform(height * width, center=center, radius=radius, dtype=dtype)
    return np.asfortranarray(flat.reshape((width, height)).T)
