"""
The instruments' random numbers: Philox4x32-10 words, and the map from
words to uniforms and normals, plain NumPy.

Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011) keyed by the 64-bit seed (low word, high word), with counter
(global step mod 2^32, global plant mod 2^32, block, 0). A plant's step
uses ``WORDS`` words, ``WORDS // 4`` blocks. A uniform is a word's top 24
bits times 2^-24; normals are Box-Muller pairs of uniforms (cosine then
sine), the radius from ``max(u1, 1e-12)``.
"""

from __future__ import annotations

import math

import numpy as np

M0, M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = np.uint64(0xFFFFFFFF)
WORDS = 76


def _mulhilo(m, x):
    p = m * x                       # < 2^64: both factors < 2^32
    return p >> np.uint64(32), p & MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Ten rounds on uint64 arrays holding 32-bit values."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = (hi1 ^ c1 ^ np.uint64(k0), lo1,
                          hi0 ^ c3 ^ np.uint64(k1), lo0)
        k0, k1 = (k0 + W0) & 0xFFFFFFFF, (k1 + W1) & 0xFFFFFFFF
    return c0, c1, c2, c3


def words(seed: int, steps: np.ndarray, plants: np.ndarray) -> np.ndarray:
    """uint32 words ``[n, WORDS, B]`` for global steps ``steps`` ``[n,
    B]`` of global plants ``plants`` ``[B]``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    n, b = steps.shape
    blocks = WORDS // 4
    shape = (n, blocks, b)
    c0 = np.broadcast_to((steps.astype(np.uint64) & MASK)[:, None, :],
                         shape)
    c1 = np.broadcast_to((plants.astype(np.uint64) & MASK)[None, None, :],
                         shape)
    c2 = np.broadcast_to(np.arange(blocks, dtype=np.uint64)[None, :, None],
                         shape)
    c3 = np.zeros(shape, np.uint64)
    out = philox4x32_10(c0, c1, c2, c3, seed & 0xFFFFFFFF, seed >> 32)
    return np.stack(out, axis=2).reshape(n, WORDS, b).astype(np.uint32)


def uniform(w, xp):
    return xp.asarray((w >> np.uint32(8)).astype(np.float64)) \
        * (1.0 / (1 << 24))


def draws(w, n_normals: int, n_uniforms: int, xp):
    """``(normals, uniforms)`` lists of arrays from the words ``w`` (``[k,
    ...]``, word-major): ``ceil(n_normals / 2)`` Box-Muller pairs, then the
    uniforms."""
    pairs = (n_normals + 1) // 2
    normals = []
    for p in range(pairs):
        u1, u2 = uniform(w[2 * p], xp), uniform(w[2 * p + 1], xp)
        r = xp.sqrt(-2.0 * xp.log(xp.maximum(u1, 1e-12)))
        theta = (2.0 * math.pi) * u2
        normals += [r * xp.cos(theta), r * xp.sin(theta)]
    uniforms = [uniform(w[2 * pairs + i], xp) for i in range(n_uniforms)]
    return normals[:n_normals], uniforms
