"""The part of JAX's default PRNG (threefry2x32, partitionable bit layout)
that the sampling head draws from, in torch integer ops.

Keys are ``(..., 2)`` int64 tensors holding uint32 words: torch's own
uint32 type lacks most arithmetic, so every word lives in an int64 and is
masked to 32 bits after each add and shift. All functions are batched over
leading dimensions and run on whatever device their inputs lie on.

What is exact and what is not: seeds, ``fold_in``, the random bits and the
uniform's mantissa construction are integer or bit operations and equal
JAX's bit for bit. The Gumbel noise takes two logs, which torch and XLA
round differently in the last bit now and then, so ``gumbel_low`` agrees
with ``jax.random.gumbel`` to about 1e-7 relative, and ``categorical`` picks
the same token unless two candidates lie that close.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY_F32 = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(key: torch.Tensor, x0, x1):
    """Threefry-2x32 of the counter pair (x0, x1) under ``key`` (..., 2):
    five groups of four rounds with a key injection after each, as JAX's
    ``threefry2x32`` lowering. x0 and x1 broadcast against ``key[..., 0]``.
    Returns the two output words (int64 in [0, 2**32))."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def seed_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: ``[0, seed mod
    2**32]`` for any Python int (negative seeds wrap), on the host."""
    return torch.tensor([0, int(seed) % 2 ** 32], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the counter ``(0,
    data)``. key (..., 2); data an int or a tensor broadcasting against
    ``key[..., 0]``. Returns the new keys (..., 2)."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=key.device)
    data = data.to(torch.int64) & M32
    y0, y1 = threefry2x32(key, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` 32-bit words per key (..., 2) -> (..., n): JAX's partitionable
    layout, counters ``(0, i)`` over the flat index and ``b1 ^ b2``."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., None, :], torch.zeros_like(i), i)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """f32 uniforms in [tiny, 1), op for op as ``jax.random.uniform(key,
    (n,), minval=tiny)`` (the Gumbel sampler's call): the top 23 bits as
    the mantissa of a float in [1, 2), minus 1, scaled by 1 - tiny (1.0 in
    f32), shifted by tiny, and held at tiny from below. The bounds stay
    Python floats: an f32 tensor op with a Python scalar computes in f32,
    and no host-to-device copy enters the step."""
    bits = (random_bits32(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    scale = float(np.float32(1.0) - np.float32(TINY_F32))
    return torch.clamp(floats * scale + TINY_F32, min=TINY_F32)


def gumbel_low(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` in its default ("low") mode, f32: -log(-log(u))
    of a uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, n)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits`` (N, V) f32 under ``keys`` (N, 2): the
    Gumbel-max trick of ``jax.random.categorical`` (first maximum on ties).
    Returns (N,) int64."""
    return torch.argmax(gumbel_low(keys, logits.shape[-1]) + logits, dim=-1)
