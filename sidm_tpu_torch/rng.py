"""Counter-based random numbers for DSMC scattering (port of
``sidm_tpu/rng.py:16-63``), bit for bit.

A key is the JAX package's raw threefry2x32 key: a pair of uint32 words,
held here as two Python ints. ``run_key`` and ``step_key`` are
``jax.random.fold_in`` on such keys, computed on the host (a few dozen
integer operations per step). ``particle_uniforms`` is the JAX package's
per-particle hash of the particle id; torch has no uint32 ``add``, ``>>``
or wrapping ``*`` on every device, so the uint32 arithmetic runs in int64
masked with ``& 0xFFFFFFFF``, each 32 x 32-bit product taken as two with
the 16-bit halves of the constant (a full product overflows int64, e.g.
0xFFFFFFFF * 0x9E3779B9).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

Key = Tuple[int, int]
M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(key: Key, x0: int, x1: int) -> Key:
    """The Threefry-2x32 hash (20 rounds) of the count pair (x0, x1)
    under ``key``, as JAX's ``threefry2x32`` primitive computes it."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x = [(x0 + ks[0]) & M32, (x1 + ks[1]) & M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & M32
    return x[0], x[1]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the hash of the 32-bit count (0, data)."""
    return threefry2x32(key, 0, data & M32)


def run_key(seed1: int, seed2: int) -> Key:
    """Root key for a run (folds both parameter-file seeds, begrun.c:44);
    ``jax.random.key(s)`` of a 31-bit seed is the pair (0, s)."""
    return fold_in((0, seed1 & 0x7FFFFFFF), seed2 & 0x7FFFFFFF)


def step_key(root: Key, step: int) -> Key:
    return fold_in(root, step)


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors a in [0, 2^32) and a constant b:
    a b = a b_lo + a b_hi 2^16 with 16-bit halves of b, each partial
    product below 2^48, so that nothing leaves int64."""
    bl, bh = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * bl + (((a * bh) & 0xFFFF) << 16)) & M32


def particle_bits(key: Key, pid: torch.Tensor, n_draws: int) -> torch.Tensor:
    """(N, n_draws) int64 holding the uint32 hash words of
    ``particle_uniforms`` (before the shift to 24 bits)."""
    h = (mul32(pid.to(torch.int64) & M32, 0x9E3779B9) + key[0]) & M32
    c = key[1]
    draws = []
    for i in range(n_draws):
        h = h ^ (h >> 16)
        h = mul32(h, 0x7FEB352D)
        h = h ^ (h >> 15)
        h = mul32(h, 0x846CA68B)
        h = h ^ (h >> 16)
        draws.append(h)
        h = (h + c + ((0x632BE5AB * (i + 1)) & M32)) & M32
    return torch.stack(draws, dim=-1)


def particle_uniforms(key: Key, pid: torch.Tensor,
                      n_draws: int) -> torch.Tensor:
    """(N, n_draws) float32 uniforms in [0, 1), independent per particle
    id: the top 24 bits of each hash word times 2^-24 (exact)."""
    bits = particle_bits(key, pid, n_draws)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def random_directions(key: Key, pid: torch.Tensor) -> torch.Tensor:
    """(N, 3) isotropic unit vectors by inverse-CDF sphere point picking
    (the JAX package's replacement of the Marsaglia loop)."""
    u = particle_uniforms(fold_in(key, 0x5D1F), pid, 2)
    cos_t = 2.0 * u[..., 0] - 1.0
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * math.pi) * u[..., 1]
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)
