"""Pieces of the fused Barnes-Hut engine that the work-queue walk uses
(port of ``sidm_tpu/ops/fused_force.py``: ``FusedConfig`` :79,
``compact_plane`` :135, ``pack_tree`` :173, ``_w_schedule`` :249,
``_far_tile`` :280, ``_near_tile`` :350, ``_classify`` :427,
``default_depth`` :890, ``make_windows`` :897; the TreePM periodic forms
``_classify(pbc)`` :426-486, ``_far_tile_pbc`` :488-578 and
``_near_tile(pbc)`` :350-420 as ``classify(pbc=)``, ``far_tile_pbc`` and
``near_tile(pbc=)``; ``min_image`` for them and the SIDM range test).

``pbc`` = (box, alpha, rcut) is the TreePM split of ``ops/pm.py``: pair
vectors by the minimum image (``box`` > 0; ``box`` 0 is the free-space
split of ``PMVacuum``, the plain vectors), the pair force screened by
S(r) and cut at ``rcut``, and the walk drops a cell that cannot reach
within ``rcut`` of a group (its force is all on the mesh). The per-pair
Ewald walk of ``PMGrid -1`` (``sidm_tpu/ops/treeforce.py``'s ``ewald``
argument) classifies with ``ewald_pbc(box)``, the periodic classification
whose cut no minimum-image distance reaches, and evaluates its pairs with
``far_tile_ewald`` and ``near_tile(ewald=)``: the minimum-image Newtonian
field plus the Ewald correction of every pair (``ops/ewald.py``).

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
from .pm import (SQRT_PI, short_range_fac, short_range_pot,
                 short_range_screen)
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
    levels_tr: Tuple[torch.Tensor, ...] = ()  # per level (cap_l,) raw
                                      # quadrupole trace (far_tile_pbc)


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
    integer fields as exact f32 (N <= 2^24); and per level the raw
    quadrupole traces (the tree's ``trq``, for the periodic far field)."""
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
    levels_tr = () if tree.trq is None else tuple(
        tree.trq[offs[l]:offs[l + 1]].contiguous() for l in range(depth + 1))
    return FusedTree(levels=tuple(levels), n_levels=list(tree.n_nodes),
                     levels_tr=levels_tr)


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
             last_level, pbc=None):
    """Opening decision per (group, slot) (``_classify``). rows (B, WC,
    16); glo/ghi (B, 3); oac (B,). Returns far, seg, opn, big boolean
    (B, WC) planes. The arithmetic order is the CUDA kernel's (so
    thresholds round identically). ``pbc`` (box, alpha, rcut): the
    bbox-to-COM distance by the minimum image about the group box's centre
    (box > 0), and a cell whose bounding sphere (bmax) cannot reach within
    rcut of the group box is dropped: neither opened nor accepted."""
    com = rows[..., R_COM]
    m = rows[..., R_MASS]
    cnt = rows[..., R_CNT]
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    if pbc is not None and pbc[0] > 0:
        gc = 0.5 * (glo + ghi)[:, None, :]
        hw = 0.5 * (ghi - glo)[:, None, :]
        delta = min_image(com - gc, pbc[0])
        dx = torch.maximum(torch.abs(delta) - hw, zero)
    else:
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
    if pbc is not None:
        # the short range's cut: no pair of the cell is nearer than
        # sqrt(r2b) - bmax
        rcut = torch.tensor(pbc[2], dtype=rows.dtype)
        live = live & (torch.sqrt(r2b) <= rcut + torch.sqrt(rows[..., R_BMAX2]))
    is_leaf = cnt <= float(leaf_cap)
    far = live & ~mac_open
    seg = live & mac_open & is_leaf
    deep = live & mac_open & ~is_leaf
    if last_level:
        return far, seg, torch.zeros_like(deep), deep
    return far, seg, deep, torch.zeros_like(deep)


def ewald_pbc(box: float):
    """The Ewald walk's classification: the periodic one (``classify(pbc=
    )``, the minimum image about the group box's centre) with a cut of
    twice the box, which no minimum-image distance (at most sqrt(3)/2 box)
    reaches: no cell of the box is dropped (JAX's walk has no cut), and the
    dead groups' cells, parked with an inverted huge box, are. alpha 0
    marks the mode (a TreePM split always has alpha > 0)."""
    return (float(box), 0.0, 2.0 * float(box))


def mode_prefix(pbc, ewald=None) -> str:
    """The prefix of a kernel mode's launch counter: "" (open), "periodic_"
    (``pbc`` with a box), "vacuum_" (box 0), "ewald_" (``ewald`` given, or
    ``ewald_pbc``'s classification, alpha 0)."""
    if ewald is not None or (pbc is not None and float(pbc[1]) == 0.0):
        return "ewald_"
    if pbc is None:
        return ""
    return "periodic_" if float(pbc[0]) > 0 else "vacuum_"


def count_launch(fn, name: str):
    """Add one to the wrapper ``fn``'s counter ``name``."""
    setattr(fn, name, getattr(fn, name) + 1)


def min_image(d, box: float):
    """``d - box*round(d/box)`` (round half to even, as ``jnp.round``);
    ``d`` itself when ``box`` is 0. The same roundings as that
    expression, in one buffer."""
    if not box:
        return d
    q = torch.round_(d / box).mul_(box)
    return torch.sub(d, q, out=q)


def range_classify(rows, glo, ghi, pad, s_l, leaf_cap, last_level,
                   box: float = 0.0, use_hmax: bool = False, drift=0.0):
    """In-range decision per (group, slot) of the SIDM range walk
    (``sidm_tpu/ops/fused_range.py:_range_classify`` :99): the cell box
    (geometric centre ``rows[..., 0:3]`` +- s_l/2) within ``pad`` of the
    group box; ``box`` > 0: by minimum-image distances from the group
    box's centre. ``use_hmax``: the hydro walk's test of
    ``sidm_tpu/ops/fused_sph.py:_sph_classify`` :116-144, within
    max(pad, hmax + drift) of the group box, hmax the cell's largest
    smoothing length (``rows[..., 3]``, ``fused_range.range_levels``) and
    ``drift`` the tree's refresh drift (a 0-d float32 tensor or a float).
    rows (B, WC, >= 8) range rows; pad (B,).
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
    eff = pad[:, None]
    if use_hmax:
        eff = torch.maximum(eff, rows[..., R_MASS] + drift)
    live = (cnt > 0) & (d2 <= eff * eff)
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


def near_tile(ent, pos_s, mass_s, eps_s, xr, te, need_pot=True, pbc=None,
              ewald=None):
    """Leaf-segment particles against one group each (``_near_tile``).

    ent (B, SC) int32 keys start*32+cnt (IMAX = dead); xr (B, G, 3) raw
    target positions; te (B, G). Raw-coordinate per-pair differencing: the
    group-centred expansion loses > 1e-2 on tight pairs. ``pbc`` (box,
    alpha, rcut): the minimum image (box > 0) and the screened pair force
    and potential (``short_range_fac``/``_pot``) cut at rcut. ``ewald``
    (an ``EwaldTable``; ``pbc`` unread): the Ewald walk's pairs
    (``treeforce.eval_flat``'s segments, :391-430): the minimum image in
    the table's box, the softened pair and its Ewald correction, uncut.
    The pair math runs on the (group, massive source) slots only, their
    terms added to their group's targets in slot order.
    Returns (dacc (B,G,3), dpot (B,G))."""
    B, SC = ent.shape
    G = xr.shape[1]
    n = pos_s.shape[0]
    live = ent != IMAX
    e = torch.where(live, ent, torch.zeros_like(ent)).long()
    start = e >> 5
    cnt = torch.where(live, e & 31, torch.zeros_like(e))
    slot = torch.arange(32, device=ent.device)
    pidx = torch.clamp((start[:, :, None] + slot).reshape(B, SC * 32),
                       max=n - 1)
    ok = (slot < cnt[:, :, None]).reshape(B, SC * 32)
    b, s = torch.nonzero(ok & (mass_s[pidx] != 0), as_tuple=True)
    p = pidx[b, s]
    m = mass_s[p][:, None]                                  # (P, 1)
    d = [xr[b, :, k] - pos_s[p, k][:, None] for k in range(3)]  # (P, G)
    h = 2.8 * torch.maximum(te[b], eps_s[p][:, None])
    if ewald is not None:
        dv = torch.stack([min_image(-dk, ewald.box) for dk in d],
                         dim=-1)                         # source - target
        r = torch.sqrt(dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1]
                       + dv[..., 2] * dv[..., 2])
        corr, pcorr = ewald.lookup(dv, need_pot)
        acc = (m * softened_inv_r3(r, h))[..., None] * dv + m[..., None] * corr
        pot = m * (softened_potential(r, h) + pcorr) if need_pot else None
    else:
        if pbc is not None and pbc[0] > 0:
            d = [min_image(dk, pbc[0]) for dk in d]
        r = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        if pbc is not None:
            cut = r <= pbc[2]
            zero = torch.zeros_like(r)
            fac = torch.where(cut, m * short_range_fac(r, h, pbc[1]), zero)
            pot = (torch.where(cut, m * short_range_pot(r, h, pbc[1]), zero)
                   if need_pot else None)
        else:
            fac = m * softened_inv_r3(r, h)
            pot = m * softened_potential(r, h) if need_pot else None
        acc = torch.stack([-fac * dk for dk in d], dim=-1)
    dacc = torch.zeros(B, G, 3, dtype=xr.dtype, device=xr.device)
    dacc.index_add_(0, b, acc)
    dpot = torch.zeros(B, G, dtype=xr.dtype, device=xr.device)
    if need_pot:
        dpot.index_add_(0, b, pot)
    return dacc, dpot


def _live_lookup(ewald, dv, live, need_pot: bool):
    """``ewald.lookup`` of the pair vectors dv (..., 3) where ``live``
    (broadcast to dv's leading shape) holds, zeros elsewhere (the pairs of
    a massless source add nothing)."""
    live = live.expand(dv.shape[:-1])
    corr = torch.zeros_like(dv)
    pcorr = torch.zeros_like(dv[..., 0]) if need_pot else None
    c, p = ewald.lookup(dv[live], need_pot)
    corr[live] = c
    if need_pot:
        pcorr[live] = p
    return corr, pcorr


def ewald_trace_pot(box: float) -> float:
    """The isotropic second-order term of a node's Ewald correction per
    unit of its raw quadrupole trace: (1/6) lap(psi) = -(2 pi / 3) / V
    (the correction's Laplacian is the neutralising background's constant
    -4 pi / V)."""
    return -(2.0 * math.pi / 3.0) / float(box) ** 3


def far_tile_ewald(rows, trq, xr, te, ewald, need_pot=True):
    """The Ewald walk's multipole of node rows against one group each
    (``treeforce.eval_flat``'s node pairs, :337-375; forcetree.c:1572):
    per-pair minimum-image vectors d = com - x from the raw targets in the
    table's box, the softened monopole and potential, the Newtonian-range
    quadrupole (-Q d / r^5 + 2.5 (d.Q.d) d / r^7, -(d.Q.d) / (2 r^5)) and
    the node mass times the Ewald correction of d; no cut. The potential
    also takes the isotropic second-order term of each node's correction,
    ``ewald_trace_pot`` times its raw quadrupole trace (the reference's
    correction at the COM alone leaves the potential energy biased by it,
    ROADMAP.md C.21; the force has no such term).

    rows (B, WC, 16) with mass zeroed on non-accepted slots; trq (B, WC)
    their raw quadrupole traces (0 on those slots); xr (B, G, 3) raw
    targets; te (B, G). Returns (dacc, dpot)."""
    m = rows[:, None, :, R_MASS]
    epsn = rows[:, None, :, R_EPS]
    q = [rows[:, None, :, 8 + j] for j in range(6)]
    d = [min_image(rows[:, None, :, k] - xr[:, :, k:k + 1], ewald.box)
         for k in range(3)]
    r = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    h = 2.8 * torch.maximum(te[:, :, None], epsn)
    fac = m * softened_inv_r3(r, h)
    zero = torch.zeros_like(r)
    newton = (r >= h) & (m > 0)
    ir = torch.where(newton, 1.0 / torch.clamp(r, min=1e-30), zero)
    ir2 = ir * ir
    w5 = ir2 * ir2 * ir
    w7 = w5 * ir2
    u = [q[0] * d[0] + q[3] * d[1] + q[4] * d[2],
         q[3] * d[0] + q[1] * d[1] + q[5] * d[2],
         q[4] * d[0] + q[5] * d[1] + q[2] * d[2]]
    dqd = d[0] * u[0] + d[1] * u[1] + d[2] * u[2]
    t7 = 2.5 * w7 * dqd
    corr, pcorr = _live_lookup(ewald, torch.stack(d, dim=-1), m > 0,
                               need_pot)
    da = [((fac + t7) * d[k] - w5 * u[k] + m * corr[..., k]).sum(-1)
          for k in range(3)]
    if need_pot:
        dpot = (m * (softened_potential(r, h) + pcorr)
                - 0.5 * dqd * w5).sum(-1) \
            + ewald_trace_pot(ewald.box) * trq.sum(-1)[:, None]
    else:
        dpot = torch.zeros_like(da[0])
    return torch.stack(da, dim=-1), dpot


def far_tile_pbc(rows, trq, xr, te, pbc, need_pot=True):
    """Periodic screened multipole of node rows against one group each
    (``_far_tile_pbc``): per-pair minimum-image vectors d = com - x from
    the raw target positions (no group-centred expansion: the wrap is per
    pair), the screened monopole, and the exact multipole expansion of the
    screened kernel psi(R) = erfc(aR)/R. With E = (2a/sqrt(pi))
    exp(-a^2 R^2) and S the screen, masked to the Newtonian range, live
    nodes and R <= rcut:
      a_q = -cA (dQd + tr R^2) d - cB (Q d) - 2.5 cB tr d,
      cA = -(2/3) a^4 E ir^2 - (5/3) a^2 E ir^4 - 2.5 S ir^7,
      cB = (2/3) a^2 E ir^2 + S ir^5,
    Q the traceless quadrupole, tr its raw trace (the Gaussian term
    dominates near rcut: S times the Newtonian quadrupole loses ~2e-2
    there).

    rows (B, WC, 16) with mass zeroed on non-accepted slots; trq (B, WC);
    xr (B, G, 3) raw targets; te (B, G). Returns (dacc, dpot)."""
    box, alpha, rcut = pbc[0], pbc[1], pbc[2]
    m = rows[:, None, :, R_MASS]
    epsn = rows[:, None, :, R_EPS]
    q = [rows[:, None, :, 8 + j] for j in range(6)]
    d = [rows[:, None, :, k] - xr[:, :, k:k + 1] for k in range(3)]
    if box > 0:
        d = [min_image(dk, box) for dk in d]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    r = torch.sqrt(r2)
    h = 2.8 * torch.maximum(te[:, :, None], epsn)
    cut = r <= rcut
    scr = short_range_screen(r, alpha) * cut
    fac = m * softened_inv_r3(r, h) * scr
    da = [(fac * d[k]).sum(-1) for k in range(3)]
    if need_pot:
        dpot = (m * short_range_pot(r, h, alpha) * cut).sum(-1)
    else:
        dpot = torch.zeros_like(da[0])
    zero = torch.zeros_like(r)
    mask = (r >= h) & (m > 0) & cut
    ir = torch.where(mask, 1.0 / torch.clamp(r, min=1e-30), zero)
    ir2 = ir * ir
    a2 = alpha * alpha
    em = torch.where(mask, (2.0 * alpha / SQRT_PI) * torch.exp(-a2 * r2),
                     zero)
    sm = torch.where(mask, short_range_screen(r, alpha), zero)
    ca = (-(2.0 / 3.0) * a2 * a2 * em * ir2
          - (5.0 / 3.0) * a2 * em * ir2 * ir2
          - 2.5 * sm * ir2 * ir2 * ir2 * ir)
    cb = (2.0 / 3.0) * a2 * em * ir2 + sm * ir2 * ir2 * ir
    u = [q[0] * d[0] + q[3] * d[1] + q[4] * d[2],
         q[3] * d[0] + q[1] * d[1] + q[5] * d[2],
         q[4] * d[0] + q[5] * d[1] + q[2] * d[2]]
    dqd = d[0] * u[0] + d[1] * u[1] + d[2] * u[2]
    trr = trq[:, None, :]
    ta = -ca * (dqd + trr * r2) - 2.5 * cb * trr
    da = [da[k] + (ta * d[k] - cb * u[k]).sum(-1) for k in range(3)]
    if need_pot:
        dpot = dpot + (0.5 * trr * sm * ir2 * ir
                       - (dqd + trr * r2) * ((1.0 / 3.0) * a2 * em * ir2
                                             + 0.5 * sm * ir2 * ir2 * ir)
                       ).sum(-1)
    return torch.stack(da, dim=-1), dpot


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
