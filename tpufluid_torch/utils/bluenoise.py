"""Blue-noise dither texture.

The reference ships a 64x64 blue-noise PNG (LDR_LLL1_0.png) sampled with
REPEAT+LINEAR to dither the bloom term by +/-1/255 (script.js:594-597). This
generates an equivalent tileable blue-noise tile with the classic
void-and-cluster algorithm (Ulichney 1993) — deterministic, seeded, computed
once per process and cached to ``_bluenoise64.npy`` beside this file. The
same algorithm and seed as ``tpufluid.utils.bluenoise``, in numpy alone.
"""

from __future__ import annotations

import os

import numpy as np

_SIZE = 64
_SIGMA = 1.9
_CACHE = None


def _gauss_energy(size: int, sigma: float) -> np.ndarray:
    """Toroidal gaussian energy kernel, centered at (0, 0)."""
    ax = np.arange(size)
    d = np.minimum(ax, size - ax).astype(np.float64)
    d2 = d[:, None] ** 2 + d[None, :] ** 2
    return np.exp(-d2 / (2.0 * sigma * sigma))


def _energy_of(mask: np.ndarray, kernel_fft: np.ndarray) -> np.ndarray:
    return np.real(np.fft.ifft2(np.fft.fft2(mask) * kernel_fft))


def blue_noise_64(seed: int = 0) -> np.ndarray:
    """64x64 float32 blue-noise in [0, 1), tileable. Cached per process."""
    global _CACHE
    if _CACHE is not None:
        return _CACHE

    cache_path = os.path.join(os.path.dirname(__file__), "_bluenoise64.npy")
    if os.path.exists(cache_path):
        _CACHE = np.load(cache_path)
        return _CACHE

    size = _SIZE
    n = size * size
    rng = np.random.default_rng(seed)
    kernel_fft = np.fft.fft2(_gauss_energy(size, _SIGMA))

    # Initial pattern: ~10% random points, relaxed so no cluster/void pairs swap.
    mask = np.zeros((size, size), dtype=np.float64)
    ones = rng.choice(n, size=n // 10, replace=False)
    mask.flat[ones] = 1.0
    for _ in range(n):
        e = _energy_of(mask, kernel_fft)
        cluster = np.argmax(np.where(mask > 0.5, e, -np.inf))
        mask.flat[cluster] = 0.0
        e = _energy_of(mask, kernel_fft)
        void = np.argmin(np.where(mask > 0.5, np.inf, e))
        if void == cluster:
            mask.flat[cluster] = 1.0
            break
        mask.flat[void] = 1.0

    rank = np.zeros((size, size), dtype=np.int64)
    initial = mask.copy()
    count = int(initial.sum())

    # Phase 1: rank the initial points by removing the tightest cluster.
    work = initial.copy()
    for r in range(count - 1, -1, -1):
        e = _energy_of(work, kernel_fft)
        cluster = np.argmax(np.where(work > 0.5, e, -np.inf))
        work.flat[cluster] = 0.0
        rank.flat[cluster] = r

    # Phase 2: fill remaining ranks by inserting into the largest void.
    work = initial.copy()
    for r in range(count, n):
        e = _energy_of(work, kernel_fft)
        void = np.argmin(np.where(work > 0.5, np.inf, e))
        work.flat[void] = 1.0
        rank.flat[void] = r

    noise = (rank.astype(np.float32) + 0.5) / n
    try:
        np.save(cache_path, noise)
    except OSError:
        pass
    _CACHE = noise
    return noise
