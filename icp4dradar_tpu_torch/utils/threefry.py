"""The JAX package's random draws, reproduced in numpy: the Threefry-2x32
counter-based generator (Salmon et al., "Parallel random numbers: as easy
as 1, 2, 3", SC 2011) with the key handling of `jax.random` in its default
partitionable mode (`key`, `split`, `uniform` over float32).

The port draws its REVE RANSAC uniforms from a `torch.Generator`; these
functions give a run on the card the draws the JAX package makes on the
same seed, so that a port run and a JAX run of the same sequence can be
compared stream by stream without the generator's spread
(`reve_uniforms`, `reve_batch_uniforms`). The streaming session
(`models/streaming.py`) keeps its key as this module's key data and draws
with it, as the JAX session does. tests/test_torch_reve.py holds them bit for bit
against `jax.random`.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32, 20 rounds, of the counters (x1, x2) under the key
    (k1, k2): uint32 arrays, broadcast against each other (many keys at
    once)."""
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _counter_bits(k: np.ndarray, n: int):
    """Threefry of the counters (0, i), i < n, under every key of k
    (..., 2): two (..., n) uint32 arrays."""
    k = np.asarray(k, np.uint32)
    i = np.arange(n, dtype=np.uint32)
    return threefry2x32(k[..., 0, None], k[..., 1, None], np.zeros_like(i), i)


def key(seed: int) -> np.ndarray:
    """`jax.random.key(seed)`'s data without 64-bit mode: (2,) uint32, zero
    and the seed's low 32 bits."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(k: np.ndarray, n: int) -> np.ndarray:
    """`jax.random.split(k, n)`'s data: (n, 2) uint32; for keys k (..., 2),
    each key's split, (..., n, 2)."""
    return np.stack(_counter_bits(k, n), axis=-1)


def uniform(k: np.ndarray, n: int) -> np.ndarray:
    """`jax.random.uniform(k, (n,))`: (n,) float32 in [0, 1), the top 23
    bits of each word as the mantissa of a float in [1, 2), less 1; for
    keys k (..., 2), each key's draws, (..., n)."""
    b1, b2 = _counter_bits(k, n)
    bits = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def doppler_uniforms(seed: int, frames: int, hypotheses: int) -> np.ndarray:
    """(frames, 2, hypotheses) float32: the Doppler RANSAC draws the JAX
    package's `run_scan_to_scan` makes with key(seed): one key a frame
    (split(key, frames)), split in two for the two hypothesis points."""
    return uniform(split(split(key(seed), frames), 2), hypotheses)


def reve_uniforms(seed: int, frames: int, block: int, hypotheses: int,
                  k: np.ndarray = None, continued: bool = False) -> np.ndarray:
    """(frames, 3 * hypotheses) float32: the REVE draws the JAX package's
    single-stream runners make with key(seed) (or the key data `k`): with
    block > 1 `run_scan_to_map_blocked` splits the key into a warm-up key
    (the first `block` frames, one split each) and a block key (the rest),
    `run_scan_to_map` into one key a frame. `continued`: the blocked runner
    continuing from an `init_state`, which has no warm-up, so every frame
    draws from the block key. For keys k (..., 2), each key's draws,
    (..., frames, 3 * hypotheses), in one call."""
    k = key(seed) if k is None else np.asarray(k, np.uint32)
    if block > 1 and continued:
        keys = split(split(k, 2)[..., 1, :], frames)
    elif block > 1 and frames > block:
        halves = split(k, 2)
        keys = np.concatenate([split(halves[..., 0, :], block),
                               split(halves[..., 1, :], frames - block)], axis=-2)
    else:
        keys = split(k, frames)
    return uniform(keys, 3 * hypotheses)


def reve_batch_uniforms(seed: int, streams: int, frames: int, block: int,
                        hypotheses: int) -> np.ndarray:
    """(streams, frames, 3 * hypotheses) float32: the REVE draws the JAX
    package's `run_scan_to_map_batch(..., key=key(seed), block=block)` makes
    for each stream. Stream b's key is split(key(seed), streams)[b], which
    the stream's runner splits as `reve_uniforms` does."""
    return reve_uniforms(seed, frames, block, hypotheses, split(key(seed), streams))
