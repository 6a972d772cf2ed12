"""The 64 x 64 blue-noise dither tile, made by the void-and-cluster
algorithm (Ulichney 1993) from seed 0 on a torus with a gaussian energy of
sigma 1.9: the reference's LDR_LLL1_0.png is such a tile. Numpy only."""

from __future__ import annotations

import numpy as np

SIZE = 64
SIGMA = 1.9


def _energy(mask: np.ndarray, kernel_fft: np.ndarray) -> np.ndarray:
    return np.real(np.fft.ifft2(np.fft.fft2(mask) * kernel_fft))


def tile(seed: int = 0) -> np.ndarray:
    """(64, 64) float32 in [0, 1): (rank + 0.5) / 4096 of each texel."""
    n = SIZE * SIZE
    d = np.minimum(np.arange(SIZE), SIZE - np.arange(SIZE)).astype(np.float64)
    kernel_fft = np.fft.fft2(np.exp(-(d[:, None] ** 2 + d[None, :] ** 2) / (2.0 * SIGMA * SIGMA)))
    rng = np.random.default_rng(seed)
    mask = np.zeros((SIZE, SIZE), dtype=np.float64)
    mask.flat[rng.choice(n, size=n // 10, replace=False)] = 1.0
    # Relax the initial points: move the tightest cluster into the largest
    # void until the two coincide.
    for _ in range(n):
        e = _energy(mask, kernel_fft)
        cluster = np.argmax(np.where(mask > 0.5, e, -np.inf))
        mask.flat[cluster] = 0.0
        e = _energy(mask, kernel_fft)
        void = np.argmin(np.where(mask > 0.5, np.inf, e))
        if void == cluster:
            mask.flat[cluster] = 1.0
            break
        mask.flat[void] = 1.0
    rank = np.zeros((SIZE, SIZE), dtype=np.int64)
    count = int(mask.sum())
    work = mask.copy()
    for r in range(count - 1, -1, -1):
        e = _energy(work, kernel_fft)
        cluster = np.argmax(np.where(work > 0.5, e, -np.inf))
        work.flat[cluster] = 0.0
        rank.flat[cluster] = r
    work = mask.copy()
    for r in range(count, n):
        e = _energy(work, kernel_fft)
        void = np.argmin(np.where(work > 0.5, np.inf, e))
        work.flat[void] = 1.0
        rank.flat[void] = r
    return (rank.astype(np.float32) + 0.5) / n
