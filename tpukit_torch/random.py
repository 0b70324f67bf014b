"""Counter-based random numbers: the port's copy of `jax.random` as tpukit
uses it (threefry2x32, `jax/_src/prng.py`; `uniform`, `gumbel`,
`categorical`, `bernoulli`, `jax/_src/random.py`), in the partitionable
layout (`jax_threefry_partitionable = True`, the setting of tpukit's
tests and the default of current jax).

A key is a `[..., 2]` tensor of 32-bit words. It is held in int64, every
sum and shift masked back to 32 bits, so the arithmetic wraps the same
way on the CPU and on CUDA (signed int32 overflow is not something to rely
on, and `torch.uint32` lacks shifts and adds on some builds). Leading key
axes are batch axes: a `[N, 2]` key draws each row's own stream, as
`jax.vmap` over a `[2]` key does.

The layout, as the installed jax has it:
  - `PRNGKey(seed)` is `(seed >> 32, seed & 0xffffffff)`;
  - `fold_in(key, d)` and the i-th key of `split(key, n)` are both
    `threefry2x32(key, (0, d))` (`(0, i)`): a two-word counter;
  - `random_bits(key, shape)` hashes each element's linear index `i` as
    the counter `(i >> 32, i & 0xffffffff)` and returns `bits1 ^ bits2`;
  - `uniform` fills a float's mantissa: `(bits >> 9) | 0x3f800000`
    read as f32, minus 1, scaled to [minval, maxval), then
    `max(minval, .)`;
  - `gumbel` is `-log(-log(uniform(tiny, 1)))`, `categorical` the argmax
    of gumbel noise + logits (first index on ties), `bernoulli(p)` is
    `uniform < p`.
Integer bits and uniforms are exact arithmetic, so they are bit-equal to
jax's; `log` may round an ulp away from XLA's, so the Gumbel noise agrees
to about 1e-6.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA  # threefry's key-schedule constant
F32_TINY = torch.finfo(torch.float32).tiny


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The `[2]` key of an integer seed: its high and low 32-bit words. A
    negative seed keeps tpukit's 32-bit reading (high word 0)."""
    seed = int(seed)
    hi = (seed >> 32) & MASK if seed >= 0 else 0
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def as_key(key, device=None) -> torch.Tensor:
    """A key given as a tensor or array of uint32 words, as int64 words."""
    if not isinstance(key, torch.Tensor):
        key = torch.from_numpy(np.asarray(key, dtype=np.int64))
    return key.to(device=device, dtype=torch.int64) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 with 20 rounds (Random123; jax's `threefry2x32_p`):
    keys `k1, k2` and counters `x0, x1` broadcast together; returns the two
    hashed words."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x0 = (x0 + k1) & MASK
    x1 = (x1 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _expand(key: torch.Tensor, ndim: int):
    """The key's two words, with `ndim` trailing axes to broadcast over."""
    shape = key.shape[:-1] + (1,) * ndim
    return key[..., 0].reshape(shape), key[..., 1].reshape(shape)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: the key hashed with the counter `(0, data)`.
    `data` is an int or a tensor broadcasting against the key's batch
    axes."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: `[..., num, 2]`, the i-th key hashed
    with the counter `(0, i)`."""
    k1, k2 = _expand(key, 1)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """32 random bits (int64 holding uint32) for every element of `shape`,
    per key: `[*key.shape[:-1], *shape]`. Element `i` (row-major) hashes
    the counter of its linear index. `offset` adds to every index: the
    rows `[r0, r0 + n)` of a larger array draw with `offset = r0 *
    prod(shape[1:])` what that array's rows draw."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = _expand(key, len(shape))
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    idx = (idx + offset).reshape(shape)
    y0, y1 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0, maxval: float = 1.0,
            offset: int = 0) -> torch.Tensor:
    """f32 uniforms on [minval, maxval) (`jax.random.uniform`). Bit-equal
    to jax's over [0, 1) and [tiny, 1), the ranges tpukit draws; over a
    wider range XLA may fuse the scale and shift into one multiply-add."""
    bits = random_bits(key, shape, offset)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference as f32 values, as jax converts them
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return (floats * scale + lo).clamp_min(lo)


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """Standard Gumbel noise, f32 (`jax.random.gumbel`, its default
    low-range mode)."""
    return -torch.log(-torch.log(uniform(key, shape, F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One index per key from f32 `logits [..., V]` (the key's batch axes
    leading): `argmax(gumbel + logits)`, first index on ties."""
    noise = gumbel(key, logits.shape[-1:])
    return torch.argmax(noise + logits, dim=-1)


def bernoulli(key: torch.Tensor, p: float, shape, offset: int = 0) -> torch.Tensor:
    """Bool draws, True with probability `p` (f32): `uniform < p`."""
    return uniform(key, shape, offset=offset) < float(np.float32(p))
