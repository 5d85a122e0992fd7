"""Level-synchronous octree from Morton-sorted particles
(port of ``sidm_tpu/ops/tree.py``: ``build_octree`` :225 and
``refresh_octree`` :432).

Same layout as the JAX ``Octree``: particles sorted by Morton key, a node
at level l is a run of equal 3l-bit key prefixes, node arrays of all levels
are concatenated at static offsets (``level_offsets``), ``mac_rows`` holds
com xyz, mass, geometric centre xyz and count, ``quad_rows`` the traceless
quadrupole (xx yy zz xy xz yz), eps_max and cell size.

Integer structure (``perm``, ``node_start``, ``node_count``,
``child_start``, ``child_count``) is exactly the JAX package's: the
permutation is one stable ``torch.sort`` of a combined key that orders like
the JAX package's two stable passes.

Moments are per-level segment sums by ``index_add_`` in float64, rounded
once to float32: the one place where the port leaves float32. The JAX
package sums in float32 with blocked prefix sums, and the quadrupole is a
difference of raw second moments that those sums carry only to ~128 eps of
their neighbourhood's magnitude: on a 4096-particle Hernquist halo that is
up to 5.6e-2 of a node's raw second moment. The float64 sums keep the
float32 moments within 1e-5 of exact.
Per-level segment ids of the sorted particles are kept on the tree
(``seg_of``) so that ``refresh_octree`` re-sums moments on the frozen
topology without re-deriving segments.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import torch

from .morton import (MAX_DEPTH, SENTINEL, bounding_cube, cell_of_prefix,
                     cell_of_prefix2, morton_keys2)


@dataclass
class Octree:
    perm: torch.Tensor         # (N,) int64 sorted order: sorted_x = x[perm]
    pos_s: torch.Tensor        # (N,3)
    mass_s: torch.Tensor       # (N,)
    eps_s: torch.Tensor        # (N,)
    keys_s: torch.Tensor       # (N,) int64 sorted level-10 hi-word keys
    mac_rows: torch.Tensor     # (M,8) com xyz, mass, centre xyz, count
    quad_rows: torch.Tensor    # (M,8) quad xx yy zz xy xz yz, eps_max, size
    node_start: torch.Tensor   # (M,) int32 first particle (sorted order)
    node_count: torch.Tensor   # (M,) int32
    child_start: torch.Tensor  # (M,) int32 FLAT index of the first child
    child_count: torch.Tensor  # (M,) int32
    seg_of: torch.Tensor       # (depth+1, N) int64 node (level-local) of
                               # each sorted particle, clipped to cap-1
    n_nodes: List[int]         # per level real node count
    origin: torch.Tensor       # (3,)
    extent: torch.Tensor       # ()
    drift: torch.Tensor        # () max displacement since the build
    level_offsets: tuple       # flat offset of each level
    depth: int
    trq: Optional[torch.Tensor] = None  # (M,) raw second-moment trace
                               # tr(Q~) about the COM (the periodic far
                               # field's exact screened quadrupole)


def _level_caps(n: int, depth: int) -> List[int]:
    return [min(8 ** l, n) for l in range(depth + 1)]


def level_offsets(n: int, depth: int) -> List[int]:
    offs = [0]
    for c in _level_caps(n, depth):
        offs.append(offs[-1] + c)
    return offs  # length depth+2; offs[l] = start of level l


def _moment_products(pos_s, m64, count=None):
    """(N, 10 or 11) float64 [m, m x, m y, m z, m xx, m yy, m zz, m xy,
    m xz, m yz (, count)]."""
    x, y, z = pos_s.double().unbind(1)
    cols = [m64, m64 * x, m64 * y, m64 * z, m64 * x * x, m64 * y * y,
            m64 * z * z, m64 * x * y, m64 * x * z, m64 * y * z]
    if count is not None:
        cols.append(count)
    return torch.stack(cols, dim=1)


def _moments(sums):
    """Segment sums -> (mass, com (cap,3), traceless quadrupole (cap,6),
    raw trace (cap,)), all float64."""
    sm = sums[:, 0]
    com = sums[:, 1:4] / torch.clamp(sm, min=1e-30)[:, None]
    sxx = sums[:, 4] - sm * com[:, 0] * com[:, 0]
    syy = sums[:, 5] - sm * com[:, 1] * com[:, 1]
    szz = sums[:, 6] - sm * com[:, 2] * com[:, 2]
    sxy = sums[:, 7] - sm * com[:, 0] * com[:, 1]
    sxz = sums[:, 8] - sm * com[:, 0] * com[:, 2]
    syz = sums[:, 9] - sm * com[:, 1] * com[:, 2]
    tr = sxx + syy + szz
    quad = torch.stack([3 * sxx - tr, 3 * syy - tr, 3 * szz - tr,
                        3 * sxy, 3 * sxz, 3 * syz], dim=1)
    return sm, com, quad, tr


def _segment_sums(seg, vals, cap):
    out = torch.zeros((cap,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg, vals)


def build_octree(pos, mass, eps, valid, *, box: float = 0.0,
                 depth: int = 10, uniform_eps: bool = False) -> Octree:
    """Build the full tree. Padding particles (valid False) sort last via a
    sentinel key and contribute nothing. ``box`` > 0: the periodic box is
    the root cube.

    uniform_eps: promise that all valid particles share one softening —
    node eps_max is then a broadcast instead of a per-node max."""
    dtype, dev = pos.dtype, pos.device
    n = pos.shape[0]
    origin, extent = bounding_cube(pos, valid, box=box)
    hi, lo = morton_keys2(pos, origin, extent, depth)
    sent = torch.full_like(hi, SENTINEL)
    hi = torch.where(valid, hi, sent)
    lo = torch.where(valid, lo, sent)
    d_hi = min(depth, MAX_DEPTH)
    d_lo = depth - d_hi
    if d_lo:
        # (hi, lo) lexicographic order with index tie-break == the JAX
        # package's two stable argsorts; valid keys are < 2^39
        key = torch.where(valid, (hi << (3 * d_lo)) | lo,
                          torch.full_like(hi, 1 << 62))
    else:
        key = hi
    perm = torch.sort(key, stable=True).indices
    keys_s = hi[perm]
    lo_s = lo[perm]
    pos_s = pos[perm]
    valid_s = valid[perm]
    mass_s = torch.where(valid_s, mass[perm], torch.zeros_like(mass))
    eps_s = eps[perm]

    caps = _level_caps(n, depth)
    offs = level_offsets(n, depth)
    M = offs[-1]
    idx = torch.arange(n, device=dev)

    m64 = mass_s.double() * valid_s.double()
    prods = _moment_products(pos_s, m64, count=valid_s.double())
    eps_valid = torch.where(valid_s, eps_s, torch.zeros_like(eps_s))
    eps_all_max = torch.max(eps_valid)

    prefs, segs = [], []
    for l in range(depth + 1):
        if l <= d_hi:
            pref = keys_s >> (3 * (d_hi - l))
            bnd = pref[1:] != pref[:-1]
        else:
            pref = lo_s >> (3 * (depth - l))
            bnd = (keys_s[1:] != keys_s[:-1]) | (pref[1:] != pref[:-1])
        boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                              bnd])
        prefs.append(pref)
        segs.append((boundary, torch.cumsum(boundary, 0) - 1))
    nv = int(valid_s.sum())
    last_valid = min(max(nv - 1, 0), n - 1)
    # real node count per level: segment id of the last valid particle
    nreal = (torch.stack([s[last_valid] for _, s in segs]) + 1).tolist()

    mac_parts, quad_parts, start_parts, cnt_parts = [], [], [], []
    trq_parts = []
    startc_l, n_nodes, seg_of = [], [], []
    for l in range(depth + 1):
        boundary, seg = segs[l]
        cap = caps[l]
        n_nodes.append(min(nreal[l], cap) if nv > 0 else 0)
        # segment starts by a scatter of boundary positions (segments past
        # cap are sentinel padding; they go to the dump slot)
        start_buf = torch.full((cap + 1,), n, dtype=torch.int64, device=dev)
        start_buf.scatter_(0, torch.where(boundary & (seg < cap), seg,
                                          torch.full_like(seg, cap)), idx)
        start = start_buf[:cap]
        startc = torch.clamp(start, max=n - 1)
        startc_l.append(startc)
        seg_c = torch.clamp(seg, max=cap - 1)
        seg_of.append(seg_c)

        sums = _segment_sums(seg_c, prods, cap)
        sm, com, quad, tr = _moments(sums)
        trq_parts.append(tr.to(dtype))
        cnt = torch.round(sums[:, 10]).long()
        live = cnt > 0
        start = torch.where(live, start, torch.zeros_like(start))
        npref = prefs[l][startc]
        if uniform_eps:
            emax = torch.where(live, eps_all_max,
                               torch.zeros_like(eps_all_max))
        else:
            emax = torch.zeros(cap, dtype=dtype, device=dev).scatter_reduce_(
                0, seg_c, eps_valid, "amax")
            emax = torch.where(live, emax, torch.zeros_like(emax))
        s_l = extent / (1 << l)
        if l <= d_hi:
            ix, iy, iz = cell_of_prefix(npref, l, d_hi)
        else:
            ix, iy, iz = cell_of_prefix2(keys_s[startc], npref, l, depth)
        center = origin + (torch.stack([ix, iy, iz], -1).to(dtype)
                           + 0.5) * s_l
        com = torch.where(live[:, None], com.to(dtype), center)
        mac_parts.append(torch.cat([com, sm.to(dtype)[:, None], center,
                                    cnt.to(dtype)[:, None]], dim=1))
        quad_parts.append(torch.cat([quad.to(dtype), emax[:, None],
                                     s_l.expand(cap)[:, None]], dim=1))
        start_parts.append(start)
        cnt_parts.append(cnt)

    node_start = torch.cat(start_parts).to(torch.int32)
    node_count = torch.cat(cnt_parts).to(torch.int32)

    # child links: a node's children are the contiguous run of level-(l+1)
    # segments spanned by its particles
    child_start = torch.zeros(M, dtype=torch.int64, device=dev)
    child_count = torch.zeros(M, dtype=torch.int64, device=dev)
    for l in range(depth):
        cap_c = caps[l + 1]
        sl = slice(offs[l], offs[l] + caps[l])
        a = startc_l[l]
        cnt_l = cnt_parts[l]
        last = torch.clamp(a + cnt_l - 1, 0, n - 1)
        seg_c = segs[l + 1][1]
        cs = torch.clamp(seg_c[a], 0, cap_c - 1)
        ce = torch.clamp(seg_c[last], 0, cap_c - 1)
        real = cnt_l > 0
        zero = torch.zeros_like(cs)
        child_count[sl] = torch.where(real, ce - cs + 1, zero)
        child_start[sl] = offs[l + 1] + torch.where(real, cs, zero)

    return Octree(
        perm=perm, pos_s=pos_s, mass_s=mass_s, eps_s=eps_s, keys_s=keys_s,
        mac_rows=torch.cat(mac_parts), quad_rows=torch.cat(quad_parts),
        node_start=node_start, node_count=node_count,
        child_start=child_start.to(torch.int32),
        child_count=child_count.to(torch.int32),
        seg_of=torch.stack(seg_of), n_nodes=n_nodes, origin=origin,
        extent=extent, drift=torch.zeros((), dtype=dtype, device=dev),
        level_offsets=tuple(offs[:-1]), depth=depth,
        trq=torch.cat(trq_parts))


def refresh_octree(tree: Octree, pos, mass, eps, valid,
                   box: float = 0.0) -> Octree:
    """Moments-only refresh on a FROZEN topology: permutation, segments,
    child links, ranges and geometric centres are reused; mass, centre of
    mass and quadrupole are re-summed from the new positions; eps_max is
    kept stale, as in the JAX package. ``drift`` accumulates the largest
    particle displacement since the build. ``box`` > 0: displacements are
    minimum-image and the refreshed positions stay in the build's wrap
    image (a particle wrapped since the build would otherwise leave its
    frozen node), as JAX's ``refresh_octree`` :464-471."""
    dtype = tree.pos_s.dtype
    n = pos.shape[0]
    perm = tree.perm
    pos_s = pos[perm]
    valid_s = valid[perm]
    mass_s = torch.where(valid_s, mass[perm], torch.zeros_like(mass))
    eps_s = eps[perm]

    d = pos_s - tree.pos_s
    if box:
        d = d - box * torch.round(d / box)
        pos_s = tree.pos_s + d
    d2 = torch.where(valid_s, torch.sum(d * d, dim=1),
                     torch.zeros_like(mass_s))
    drift = tree.drift + torch.sqrt(torch.max(d2))

    caps = _level_caps(n, tree.depth)
    offs = level_offsets(n, tree.depth)
    prods = _moment_products(pos_s, mass_s.double())
    mac_parts, quad_parts, trq_parts = [], [], []
    for l in range(tree.depth + 1):
        cap = caps[l]
        sl = slice(offs[l], offs[l] + cap)
        sm, com, quad, tr = _moments(_segment_sums(tree.seg_of[l], prods,
                                                   cap))
        trq_parts.append(tr.to(dtype))
        old_mac = tree.mac_rows[sl]
        center = old_mac[:, 4:7]
        com = torch.where((sm > 0)[:, None], com.to(dtype), center)
        mac_parts.append(torch.cat([com, sm.to(dtype)[:, None], center,
                                    old_mac[:, 7:8]], dim=1))
        quad_parts.append(torch.cat([quad.to(dtype),
                                     tree.quad_rows[sl, 6:8]], dim=1))
    return dataclasses.replace(
        tree, pos_s=pos_s, mass_s=mass_s, eps_s=eps_s,
        mac_rows=torch.cat(mac_parts), quad_rows=torch.cat(quad_parts),
        trq=torch.cat(trq_parts), drift=drift)
