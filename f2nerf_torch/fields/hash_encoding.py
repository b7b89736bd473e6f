"""Hash-grid constants and init helpers shared by the fields (the part of
``f2nerf_tpu/fields/hash_encoding.py`` the HashBlock field uses; the
Hash3DAnchored field itself is not ported yet).

  * N_LEVELS=16 levels, N_CHANNELS=2 features, per-level grid resolution
    2^3 .. 2^10 geometric (Hash3DAnchored.h:15-20, .cu:28).
  * Per-(level, volume) random prime hash seeds in [2^28, 2^30)
    (Hash3DAnchored.cpp:38-69).
"""

from __future__ import annotations

import numpy as np

N_CHANNELS = 2
N_LEVELS = 16
RES_BASE_POW_2 = 3.0
RES_FINE_POW_2 = 10.0


def level_scales() -> np.ndarray:
    """Per-level grid resolution multiplier, f32 (Hash3DAnchored.cu:28)."""
    l = np.arange(N_LEVELS, dtype=np.float32)
    return np.exp2((RES_FINE_POW_2 - RES_BASE_POW_2) * l / (N_LEVELS - 1) + RES_BASE_POW_2)


def _small_primes(limit: int) -> np.ndarray:
    sieve = np.ones(limit, bool)
    sieve[:2] = False
    for p in range(2, int(limit ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p::p] = False
    return np.nonzero(sieve)[0].astype(np.int64)


def _random_primes(seeds: np.ndarray) -> np.ndarray:
    """Advance each seed to the next prime (vectorized; init only).
    Candidates are < 2^30, so trial division by primes <= 2^15 is exact.
    Runs in chunks of 2048 seeds to bound the [seeds, primes] temporary,
    and tests only the candidates still composite."""
    primes = _small_primes(1 << 15)[1:]  # odd primes
    cand = (np.asarray(seeds, np.int64) | 1).copy()
    for lo in range(0, cand.shape[0], 2048):
        part = cand[lo:lo + 2048]
        active = np.arange(part.shape[0])
        for _ in range(200):
            composite = (part[active, None] % primes[None, :] == 0).any(axis=1)
            active = active[composite]
            if not active.size:
                break
            part[active] += 2
    return cand
