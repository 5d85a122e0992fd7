"""Morton (Z-order) keys (port of ``sidm_tpu/ops/morton.py:45,72``).

Keys are held in int64: torch's CPU build has no uint32 shift or add. The
values are the JAX package's uint32 keys bit for bit (every key fits in 30
bits; the padding sentinel is 0xFFFFFFFF).
"""

from __future__ import annotations

import torch

MAX_DEPTH = 10  # 3*10 = 30 bits per word
SENTINEL = 0xFFFFFFFF


def _expand_bits(v):
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v.long() & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _interleave(ij):
    return ((_expand_bits(ij[:, 0]) << 2) | (_expand_bits(ij[:, 1]) << 1)
            | _expand_bits(ij[:, 2]))


def morton_keys2(pos, origin, extent, depth: int):
    """(hi, lo) int64 keys: hi = the 30-bit key of the first min(depth,10)
    levels, lo = the remaining (depth-10)*3 bits (0 for depth <= 10)."""
    d_hi = min(depth, MAX_DEPTH)
    d_lo = depth - d_hi
    grid = float(1 << depth)
    x = (pos - origin) / extent * grid
    ij = torch.clamp(x, 0.0, grid - 1.0).to(torch.int32).long()
    hi = _interleave(ij >> d_lo)
    if d_lo == 0:
        return hi, torch.zeros_like(hi)
    return hi, _interleave(ij & ((1 << d_lo) - 1))


def bounding_cube(pos, valid, box: float = 0.0, pad: float = 1.001):
    """(origin (3,), extent ()) cube enclosing all valid positions; with a
    periodic ``box`` the box itself (the tree is built over the box
    domain)."""
    if box:
        return (torch.zeros(3, dtype=pos.dtype, device=pos.device),
                torch.full((), box, dtype=pos.dtype, device=pos.device))
    inf = torch.full_like(pos, float("inf"))
    lo = torch.min(torch.where(valid[:, None], pos, inf), dim=0).values
    hi = torch.max(torch.where(valid[:, None], pos, -inf), dim=0).values
    ext = torch.clamp(torch.max(hi - lo) * pad, min=1e-10)
    center = 0.5 * (lo + hi)
    return center - 0.5 * ext, ext


def _compact_bits(v):
    v = v & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & 0x3FF
    return v


def cell_of_prefix(prefix, level: int, depth: int = MAX_DEPTH):
    """Integer (ix, iy, iz) of a node from its 3*level-bit Morton prefix."""
    p = (prefix << (3 * (depth - level))) & SENTINEL
    shift = depth - level
    return ((_compact_bits(p >> 2) >> shift), (_compact_bits(p >> 1) >> shift),
            (_compact_bits(p) >> shift))


def cell_of_prefix2(hipref, lopref, level: int, depth: int):
    """(ix, iy, iz) at ``level`` from two-word prefixes (morton_keys2)."""
    d_hi = min(depth, MAX_DEPTH)
    d_lo = depth - d_hi
    if level <= d_hi:
        return cell_of_prefix(hipref, level, d_hi)
    hx, hy, hz = cell_of_prefix(hipref, d_hi, d_hi)
    dl = level - d_hi
    p = lopref << (3 * (d_lo - dl))
    sh = d_lo - dl
    lx = _compact_bits(p >> 2) >> sh
    ly = _compact_bits(p >> 1) >> sh
    lz = _compact_bits(p) >> sh
    return (hx << dl) | lx, (hy << dl) | ly, (hz << dl) | lz
