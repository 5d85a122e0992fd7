"""Pieces of the fused Barnes-Hut engine that the work-queue walk uses
(port of ``sidm_tpu/ops/fused_force.py``: ``FusedConfig`` :79,
``compact_plane`` :135, ``pack_tree`` :173, ``_w_schedule`` :249,
``_far_tile`` :280, ``_near_tile`` :350, ``_classify`` :427,
``default_depth`` :890, ``make_windows`` :897; non-periodic forms only,
but for the SIDM range test's minimum image, ``min_image``).

Semantics are the JAX package's (reference: force_treeevaluate,
forcetree.c:786-1377): targets are 64-wide Morton windows restarted at
level-L cell boundaries, the opening criterion is evaluated once per
(group, node) against the group bounding box, accepted multipoles are
group-centred monopole + Newtonian-range quadrupole, and leaf segments are
(start, count <= 31) particle ranges evaluated by raw-coordinate pair
differencing.

One layout differs: the JAX package packs near-field particles 16 to a
128-lane row (``part16``), a TPU lane layout. The port reads the sorted
``pos_s``/``mass_s``/``eps_s`` arrays directly; a segment key
``start*32+cnt`` still covers particles ``start .. start+cnt-1``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from ..kernels import softened_inv_r3, softened_potential
from .tree import Octree, level_offsets

IMAX = 2147483647

# The JAX FusedConfig's defaults, fixed here: the CUDA kernels are compiled
# for G and WC (csrc/far_kernel.cu kG, kWC; csrc/near_kernel.cu kG).
G = 64             # targets per group
WC = 128           # frontier ids per far (group, chunk) item
SC = 16            # segment keys per near (group, chunk) item
START_LEVEL = 2    # the walk's first level
LEAF_CAP = 16      # an opened node of <= LEAF_CAP particles is a leaf
BREAK_LEVEL = 4    # target windows restart at this level's cells
GROUP_BLOCK = 32   # the group count is padded to a multiple of this


class FusedConfig(NamedTuple):
    """The caps that bound the accepted pair sets, as in the JAX package;
    their overflow is counted in ``info``. The JAX package's static item
    caps and super-block sizes (``wq_cap``, ``wq_near_cap``, ``wq_block``,
    ``wq_near_block``) are TPU scheduling artefacts with no counterpart
    here: torch shapes are dynamic and each kernel walks a group's whole
    frontier."""
    w_max: int = 6144          # frontier width cap per level
    open_cap: int = 1024       # opened cells kept per (group, level)
    big_cap: int = 8           # overfull deepest cells per group
    big_chunks: int = 8        # 16-particle chunks per overfull cell


class FusedTree(NamedTuple):
    levels: Tuple[torch.Tensor, ...]  # per level (cap_l, 16) f32 node rows
    n_levels: List[int]               # per level real node count


# packed node row layout (pack_tree)
R_COM = slice(0, 3)
R_MASS = 3
R_CNT = 4
R_NSTART = 5
R_CSTART = 6
R_CCNT = 7
R_QUAD = slice(8, 14)
R_EPS = 14
R_BMAX2 = 15


def compact_plane(keys):
    """Stable left-compaction of the non-IMAX entries of each row; the
    tail is filled with IMAX. Returns (compacted (ng, W), live counts)."""
    ng, W = keys.shape
    live = keys != IMAX
    dst = torch.cumsum(live, dim=1, dtype=torch.int32) - 1
    dst = torch.where(live, dst, torch.full_like(dst, W)).long()
    out = torch.full((ng, W + 1), IMAX, dtype=keys.dtype,
                     device=keys.device)
    out.scatter_(1, dst, keys)
    return out[:, :W], torch.sum(live, dim=1, dtype=torch.int32)


def pack_tree(tree: Octree) -> FusedTree:
    """Per-level 16-wide node rows [com xyz, mass, count, node_start,
    level-local child_start, child_count, quad(6), eps_max, bmax^2];
    integer fields as exact f32 (N <= 2^24)."""
    n = tree.pos_s.shape[0]
    depth = tree.depth
    offs = level_offsets(n, depth)
    dtype = tree.pos_s.dtype
    levels = []
    for l in range(depth + 1):
        sl = slice(offs[l], offs[l + 1])
        mac = tree.mac_rows[sl]
        quad = tree.quad_rows[sl]
        child_local = tree.child_start[sl] - (offs[l + 1] if l < depth else 0)
        # bmax: |com - centre| + (sqrt(3)/2) len + drift, the reference's
        # BMAX guard inflated by the refresh drift (forcetree.c:1254-1257)
        d = mac[:, 0:3] - mac[:, 4:7]
        bmax = (torch.sqrt(torch.sum(d * d, dim=1, keepdim=True))
                + 0.8660255 * quad[:, 7:8] + tree.drift)
        levels.append(torch.cat([
            mac[:, 0:3], mac[:, 3:4], mac[:, 7:8],
            tree.node_start[sl, None].to(dtype),
            torch.clamp(child_local, min=0)[:, None].to(dtype),
            tree.child_count[sl, None].to(dtype),
            quad[:, 0:6], quad[:, 6:7], bmax * bmax], dim=1).contiguous())
    return FusedTree(levels=tuple(levels), n_levels=list(tree.n_nodes))


def flat_tables(ftree: FusedTree):
    """All-level node table (M, 16) for flat-id gathers (JAX
    ``list_force.flat_tables``)."""
    return torch.cat(list(ftree.levels), dim=0)


def w_schedule(cfg: FusedConfig, depth: int, n: int, theta: float,
               use_relative: bool):
    """Frontier width cap per level (``_w_schedule``; the cap widens for a
    small geometric theta)."""
    wmax = cfg.w_max
    if not use_relative and theta < 0.5:
        wmax = min(int(wmax * min((0.5 / max(theta, 0.1)) ** 3, 8.0)), 8192)

    def round_w(w):
        if w >= WC:
            return -(-w // WC) * WC
        p = 8
        while p < w:
            p *= 2
        return p

    ws = {}
    caps = [min(8 ** l, n) for l in range(depth + 1)]
    w = min(8 ** START_LEVEL, caps[START_LEVEL], wmax)
    for l in range(START_LEVEL, depth + 1):
        if l >= START_LEVEL + 2:
            w = wmax
        w = round_w(max(min(w, caps[l], wmax), 8))
        ws[l] = w
        w = w * 8
    return ws


def classify(rows, glo, ghi, oac, s_l, theta2, use_relative, leaf_cap,
             last_level):
    """Opening decision per (group, slot) (``_classify``, non-periodic).
    rows (B, WC, 16); glo/ghi (B, 3); oac (B,). Returns far, seg, opn, big
    boolean (B, WC) planes. The arithmetic order is the Pallas kernel's
    (so thresholds round identically)."""
    com = rows[..., R_COM]
    m = rows[..., R_MASS]
    cnt = rows[..., R_CNT]
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    dx = torch.maximum(torch.maximum(glo[:, None, :] - com,
                                     com - ghi[:, None, :]), zero)
    r2b = (dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1]
           + dx[..., 2] * dx[..., 2])
    s2 = s_l * s_l
    geo = s2 > theta2 * r2b
    if use_relative:
        rel = m * (s2 * s2) > oac[:, None] * r2b * r2b * r2b
        mac_open = torch.where(oac[:, None] > 0, rel, geo)
    else:
        mac_open = geo
    mac_open = mac_open | (r2b <= rows[..., R_BMAX2])
    live = cnt > 0
    is_leaf = cnt <= float(leaf_cap)
    far = live & ~mac_open
    seg = live & mac_open & is_leaf
    deep = live & mac_open & ~is_leaf
    if last_level:
        return far, seg, torch.zeros_like(deep), deep
    return far, seg, deep, torch.zeros_like(deep)


def min_image(d, box: float):
    """``d - box*round(d/box)`` (round half to even, as ``jnp.round``);
    ``d`` itself when ``box`` is 0. The same roundings as that
    expression, in one buffer."""
    if not box:
        return d
    q = torch.round_(d / box).mul_(box)
    return torch.sub(d, q, out=q)


def range_classify(rows, glo, ghi, pad, s_l, leaf_cap, last_level,
                   box: float = 0.0):
    """In-range decision per (group, slot) of the SIDM range walk
    (``sidm_tpu/ops/fused_range.py:_range_classify`` :99): the cell box
    (geometric centre ``rows[..., 0:3]`` +- s_l/2) within ``pad`` of the
    group box; ``box`` > 0: by minimum-image distances from the group
    box's centre. rows (B, WC, >= 8) range rows; pad (B,).
    Returns far (none), seg, opn, big boolean (B, WC) planes."""
    ctr = rows[..., R_COM]
    cnt = rows[..., R_CNT]
    half = 0.5 * s_l
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    if box:
        gc = 0.5 * (glo + ghi)[:, None, :]
        hw = 0.5 * (ghi - glo)[:, None, :]
        delta = min_image(ctr - gc, box)
        dx = torch.maximum(torch.abs(delta) - hw - half, zero)
    else:
        dx = torch.maximum(torch.maximum(glo[:, None, :] - ctr,
                                         ctr - ghi[:, None, :]) - half, zero)
    d2 = (dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1]
          + dx[..., 2] * dx[..., 2])
    live = (cnt > 0) & (d2 <= (pad * pad)[:, None])
    is_leaf = cnt <= float(leaf_cap)
    seg = live & is_leaf
    deep = live & ~is_leaf
    none = torch.zeros_like(deep)
    if last_level:
        return none, seg, none, deep
    return none, seg, deep, none


def far_tile(rows, xc, te, gc, need_pot=True):
    """Monopole + quadrupole of node rows against one group each
    (``_far_tile``, written as the Pallas kernel writes it).

    rows (B, WC, 16) with mass zeroed on non-accepted slots; xc (B, G, 3)
    group-centred targets; te (B, G); gc (B, 3). Returns (dacc (B,G,3),
    dpot (B,G))."""
    com = rows[..., R_COM] - gc[:, None, :]                 # (B,WC,3)
    cc = [com[:, None, :, d] for d in range(3)]             # (B,1,WC)
    m = rows[:, None, :, R_MASS]
    epsn = rows[:, None, :, R_EPS]
    q = [rows[:, None, :, 8 + j] for j in range(6)]
    x = [xc[:, :, d:d + 1] for d in range(3)]               # (B,G,1)
    tcol = te[:, :, None]

    ny2 = cc[0] * cc[0] + cc[1] * cc[1] + cc[2] * cc[2]
    nx2 = x[0] * x[0] + x[1] * x[1] + x[2] * x[2]
    cross = x[0] * cc[0] + x[1] * cc[1] + x[2] * cc[2]      # (B,G,WC)
    r2 = torch.clamp(nx2 + ny2 - 2.0 * cross, min=0.0)
    r = torch.sqrt(r2)
    h = 2.8 * torch.maximum(tcol, epsn)
    fac = m * softened_inv_r3(r, h)
    fsum = fac.sum(-1)
    da = [(fac * cc[d]).sum(-1) - x[d][..., 0] * fsum for d in range(3)]
    if need_pot:
        dpot = (m * softened_potential(r, h)).sum(-1)
    else:
        dpot = torch.zeros_like(fsum)

    # quadrupole, Newtonian range only (forcetree.c:1002-1060)
    newton = (r >= h) & (m > 0)
    ir = torch.where(newton, 1.0 / torch.clamp(r, min=1e-30),
                     torch.zeros_like(r))
    ir2 = ir * ir
    w5 = ir2 * ir2 * ir
    w7 = w5 * ir2
    u = [q[0] * cc[0] + q[3] * cc[1] + q[4] * cc[2],
         q[3] * cc[0] + q[1] * cc[1] + q[5] * cc[2],
         q[4] * cc[0] + q[5] * cc[1] + q[2] * cc[2]]
    s = u[0] * cc[0] + u[1] * cc[1] + u[2] * cc[2]
    xu = x[0] * u[0] + x[1] * u[1] + x[2] * u[2]
    phi = [x[0] * x[0], x[1] * x[1], x[2] * x[2], 2.0 * x[0] * x[1],
           2.0 * x[0] * x[2], 2.0 * x[1] * x[2]]
    xqx = (phi[0] * q[0] + phi[1] * q[1] + phi[2] * q[2] + phi[3] * q[3]
           + phi[4] * q[4] + phi[5] * q[5])
    dqd = s - 2.0 * xu + xqx
    w5u = [(w5 * u[d]).sum(-1) for d in range(3)]
    mw = [(w5 * q[j]).sum(-1) for j in range(6)]
    xs = [x[d][..., 0] for d in range(3)]
    qxv = [mw[0] * xs[0] + mw[3] * xs[1] + mw[4] * xs[2],
           mw[3] * xs[0] + mw[1] * xs[1] + mw[5] * xs[2],
           mw[4] * xs[0] + mw[5] * xs[1] + mw[2] * xs[2]]
    t7 = w7 * dqd
    t7sum = t7.sum(-1)
    da = [da[d] - w5u[d] + qxv[d]
          + 2.5 * ((t7 * cc[d]).sum(-1) - xs[d] * t7sum) for d in range(3)]
    if need_pot:
        dpot = dpot - 0.5 * (dqd * w5).sum(-1)
    return torch.stack(da, dim=-1), dpot


def near_tile(ent, pos_s, mass_s, eps_s, xr, te, need_pot=True):
    """Leaf-segment particles against one group each (``_near_tile``).

    ent (B, SC) int32 keys start*32+cnt (IMAX = dead); xr (B, G, 3) raw
    target positions; te (B, G). Raw-coordinate per-pair differencing: the
    group-centred expansion loses > 1e-2 on tight pairs. Returns (dacc
    (B,G,3), dpot (B,G))."""
    B, SC = ent.shape
    n = pos_s.shape[0]
    live = ent != IMAX
    e = torch.where(live, ent, torch.zeros_like(ent)).long()
    start = e >> 5
    cnt = torch.where(live, e & 31, torch.zeros_like(e))
    slot = torch.arange(32, device=ent.device)
    pidx = (start[:, :, None] + slot).reshape(B, SC * 32)
    ok = (slot < cnt[:, :, None]).reshape(B, SC * 32)
    pidx = torch.clamp(pidx, max=n - 1)
    y = pos_s[pidx]                                         # (B,S,3)
    ym = torch.where(ok, mass_s[pidx], torch.zeros_like(mass_s[pidx]))
    yeps = eps_s[pidx]
    d = [xr[:, :, None, k] - y[:, None, :, k] for k in range(3)]
    r = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    h = 2.8 * torch.maximum(te[:, :, None], yeps[:, None, :])
    fac = ym[:, None, :] * softened_inv_r3(r, h)
    dacc = torch.stack([-(fac * d[k]).sum(-1) for k in range(3)], dim=-1)
    if need_pot:
        dpot = (ym[:, None, :] * softened_potential(r, h)).sum(-1)
    else:
        dpot = torch.zeros(dacc.shape[:2], dtype=dacc.dtype,
                           device=dacc.device)
    return dacc, dpot


def default_depth(n: int) -> int:
    """Deep enough that the densest cells fit the big path; shallow for
    small n."""
    return 10 if n <= (1 << 18) else 13


def make_windows(keys_s, valid_s, n: int, depth: int):
    """Morton target windows of G slots restarted at level-L cell
    boundaries (L = BREAK_LEVEL or shallower for small n), ordered by the
    particle count of their break cell (a local density proxy).

    Returns (pidx (ngp, G) sorted particle index per slot, gvalid)."""
    dev = keys_s.device
    L = max(0, min(BREAK_LEVEL, depth,
                   int(math.log(max(n // G, 1), 8) + 1e-9)))
    idx = torch.arange(n, device=dev)
    prefL = keys_s >> (3 * (min(depth, 10) - L))
    newcell = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         prefL[1:] != prefL[:-1]])
    # the start of each particle's run (JAX: a running max of the starts)
    run_id_s = torch.cumsum(newcell, 0) - 1
    run_start = torch.nonzero(newcell).flatten()[run_id_s]
    newgroup = newcell | (((idx - run_start) % G) == 0)
    gid = torch.cumsum(newgroup, 0) - 1
    NGC0 = -(-n // G) + min(8 ** L, n)
    GB = min(GROUP_BLOCK, max(NGC0, 1))
    ngp = -(-NGC0 // GB) * GB

    def starts(flag, ids, size):
        buf = torch.full((size + 1,), n, dtype=torch.int64, device=dev)
        buf.scatter_(0, torch.where(flag, ids, torch.full_like(ids, size)),
                     idx)
        s0 = buf[:size]
        nxt = torch.cat([s0[1:], torch.full((1,), n, device=dev)])
        return s0, torch.clamp(torch.clamp(nxt, max=n) - s0, min=0)

    gstart0, gcount = starts(newgroup, gid, ngp)
    gstart = torch.where(gcount > 0, gstart0, torch.zeros_like(gstart0))
    # stable, as jnp.argsort
    _, run_len = starts(newcell, run_id_s, min(8 ** L, n) + 1)
    rid_of_group = run_id_s[torch.clamp(gstart0, max=n - 1)]
    proxy = torch.where(gcount > 0, run_len[rid_of_group],
                        torch.full_like(gcount, -1))
    order = torch.sort(-proxy, stable=True).indices
    gstart = gstart[order]
    gcount = gcount[order]
    slot = torch.arange(G, device=dev)
    pidx = torch.clamp(gstart[:, None] + slot, max=n - 1)
    gvalid = (slot < gcount[:, None]) & valid_s[pidx]
    return pidx, gvalid
