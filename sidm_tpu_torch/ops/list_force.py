"""Cached interaction lists: walk once, evaluate every step (port of
``sidm_tpu/ops/list_force.py``: ``ListConfig`` :55, ``InteractionLists``
:92, ``flat_tables`` :120 (in ``fused_force``), ``_append_plane`` :127,
``_record`` :220, ``record_lists`` :370, ``max_displacement`` :491,
``node_velocities`` :497, ``advance_tree`` :509, ``eval_lists`` :687 with
``_eval``'s gather form :604-684).

``record_lists`` walks a freshly built tree once per rebuild, level by
level as the work-queue walk does, but records the classification instead
of evaluating it: per target group, the flat ids of the nodes accepted as
multipoles ("far") and the segment keys ``start*32+cnt`` of the opened
leaves and of the overfull deepest cells' 16-particle chunks ("near"). The
group boxes are grown by a ``skin``, so the acceptances stay MAC-valid
while no particle has moved more than skin/2. Each level runs the far
kernel in its record mode (``far_level(..., lists=...)``), which appends
the level's accepted nodes and segment keys to each group's lists under
``far_cap`` and ``near_cap`` (and ``lvl_cap`` where one is given) with the
JAX package's drops (each row's live prefix, in frontier order) and its
``ovf``/``need`` telemetry (``_append_plane`` :127 is the plain version's
``_append``). The far ids are then
renumbered into a compact table of the used nodes (``src``, ``used_cap``).

``eval_lists`` is the per-step force: the compact node table is gathered
from the current tree's node arrays (``gather_nodes``), the far pass is
``far_list`` and the near pass the walk's ``near_level`` on the recorded
keys. With ``pbc`` (a TreePM box, JAX's ``pbc`` arguments :162-189,
:631-636, :746-747) the recording walk and both passes take their
periodic modes, and with ``pbc`` of box 0 (``PMVacuum``, an isolated run's
TreePM split) their free-space modes. Between rebuilds ``advance_tree`` drifts the node centres
of mass by the node velocities recorded at the rebuild (``vcom``), as the
reference predicts nodes within a tree-update period
(forcetree.c:941-948).

Not ported: ``ListConfig.materialize``/``matf``, a TPU workaround that
streams the far rows recorded item by item instead of gathering them (ROADMAP
C). The gather form computes the same function. The TPU schedule knobs
(``fc``, ``sc``, ``far_block``, ``near_block``, ``sort_eval``) have no
counterpart: each kernel walks a group's whole list.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .far_kernel import (C_NEXT, S_NEED_F, S_NEED_N, S_OVF_L, S_OVF_N,
                         far_level, list_buf)
from .far_list import far_list
from .fused_force import (LEAF_CAP, START_LEVEL, FusedConfig, FusedTree,
                          make_windows, pack_tree, w_schedule)
from .gather import gather_nodes
from .near_kernel import near_level
from .pm import SQRT_PI
from .tree import Octree, level_offsets
from .wq_force import group_boxes, ungroup


class ListConfig(NamedTuple):
    """The caps that decide which pairs are recorded and when the engine
    overflows (the JAX defaults: the flagship's measured demand of
    far/grp 7020, near/grp 4421 and 231881 used nodes, plus ~15%).

    ``lvl_cap`` bounds one level's appended entries per group. The JAX
    package's 3072 is the width of its TPU append network; here a level is
    appended by one scatter whatever its width, so by default there is no
    level cap (ROADMAP C). The JAX-parity tests set it to reproduce JAX's
    drops."""
    far_cap: int = 8192       # per-group recorded far (node) entries
    near_cap: int = 5120      # per-group recorded near (segment) entries
    lvl_cap: Optional[int] = None  # per-level recording width (None: none)
    used_cap: int = 294912    # distinct nodes in the compact gather table


class InteractionLists(NamedTuple):
    far: torch.Tensor      # (ngp, LF) int32 compact-table ids (dead = U)
    near: torch.Tensor     # (ngp, LN) int32 segment keys start*32+cnt
    nf: torch.Tensor       # (ngp,) int32 live far count
    nn: torch.Tensor       # (ngp,) int32 live near count
    pidx: torch.Tensor     # (ngp, G) int64 sorted-order target index
    gvalid: torch.Tensor   # (ngp, G) bool
    pos_ref: torch.Tensor  # (n, 3) sorted positions at record time
    ovf: torch.Tensor      # (4,) int64 drops [level and walk caps,
                           #  far_cap, near_cap, used_cap]
    skin: torch.Tensor     # () skin the record used
    vcom: torch.Tensor     # (M, 3) node mass-weighted mean velocity
    t_ref: torch.Tensor    # () simulation time at record
    src: torch.Tensor      # (U,) int32 flat node id of each compact row
    need: torch.Tensor     # (3,) int64 uncapped demand [max far/group,
                           #  max near/group, distinct used nodes]


def _record(ftree: FusedTree, glo, ghi, oac, extent, drift, *, theta: float,
            use_relative: bool, cfg: FusedConfig, lcfg: ListConfig,
            depth: int, n: int, on_level=None, pbc=None):
    """The recording walk (``_record``): every level's accepted nodes and
    segment keys (and the last level's big-cell chunks) are appended to the
    per-group lists by ``far_level`` in record mode (its periodic mode with
    ``pbc``). Returns (far flat ids, near keys, nf, nn, ovf (3,), need
    (2,)). on_level: optional observer called as ``on_level(level, kw)``
    before every ``far_level`` call."""
    ng = glo.shape[0]
    dev = glo.device
    ws = w_schedule(cfg, depth, n, theta, use_relative)
    offs = level_offsets(n, depth)
    buf = list_buf(ng, lcfg.far_cap, lcfg.near_cap, dev)
    W0 = ws[START_LEVEL]
    fids = torch.arange(W0, dtype=torch.int32,
                        device=dev).repeat(ng, 1).contiguous()
    n_live = torch.full((ng,), W0, dtype=torch.int32, device=dev)

    for l in range(START_LEVEL, depth + 1):
        last = l == depth
        kw = dict(fids=fids, n_live=n_live, tbl=ftree.levels[l],
                  nl_real=ftree.n_levels[l],
                  s_l=extent / (1 << l) + 2.0 * drift, glo=glo, ghi=ghi,
                  oac=oac, theta2=theta * theta,
                  use_relative=use_relative, leaf_cap=LEAF_CAP, last=last,
                  Wn=0 if last else ws[l + 1],
                  open_cap=cfg.open_cap, big_cap=cfg.big_cap,
                  big_chunks=cfg.big_chunks, lists=buf, lvl_base=offs[l],
                  lvl_cap=lcfg.lvl_cap, pbc=pbc)
        if on_level is not None:
            on_level(l, kw)
        out = far_level(**kw)
        fids, n_live = out.fids, out.cnt[C_NEXT]

    stat = buf.stat.long()
    return (buf.far, buf.near, buf.nf, buf.nn,
            torch.sum(stat[S_OVF_L:S_OVF_N + 1], dim=1),
            torch.amax(stat[S_NEED_F:S_NEED_N + 1], dim=1))


def record_lists(tree: Octree, old_acc_sorted, valid_sorted, *, theta=0.5,
                 use_relative=True, err_tol_force_acc=0.005,
                 cfg: Optional[FusedConfig] = None,
                 lcfg: Optional[ListConfig] = None, skin=0.0, vel=None,
                 t_now=0.0, on_level=None, pbc=None) -> InteractionLists:
    """Interaction lists for every target group of a fresh ``tree``.

    old_acc_sorted: |a_old| in sorted order (relative criterion input);
    valid_sorted: particle validity in sorted order; vel: velocities in
    original order (for ``vcom``; zeros if None). The groups are the
    walk's Morton windows, so at skin 0 on a fresh tree the lists hold the
    walk's pair partition exactly. ``pbc`` (box, alpha, rcut): the TreePM
    short range in a periodic box (the tree built on the box; JAX
    list_force.py:392-405 with pbc): the skin-grown group boxes are
    classified by the minimum image about their centres, cells beyond
    rcut + bmax are dropped, and dead groups are parked with an inverted
    huge box; with box 0 (``PMVacuum``) by the plain box distance, with
    the cut, and dead groups parked outside the tree (JAX :406-409).
    on_level: see ``_record``."""
    cfg = cfg or FusedConfig()
    lcfg = lcfg or ListConfig()
    n = tree.pos_s.shape[0]
    depth = tree.depth
    dtype, dev = tree.pos_s.dtype, tree.pos_s.device
    ftree = pack_tree(tree)
    pidx, gvalid = make_windows(tree.keys_s, valid_sorted, n, depth)
    gtargets = tree.pos_s[pidx]
    toac = (old_acc_sorted * err_tol_force_acc).to(dtype)
    goac = torch.where(gvalid, toac[pidx], torch.zeros_like(toac[pidx]))
    skin = torch.as_tensor(skin, dtype=dtype, device=dev)
    glo, ghi, oac = group_boxes(tree, gtargets, gvalid, goac, skin,
                                periodic=pbc is not None and pbc[0] > 0)
    if pbc is not None:
        pbc = tuple(float(v) for v in pbc)

    far, near, nf, nn, ovf, need = _record(
        ftree, glo, ghi, oac, tree.extent, tree.drift, theta=float(theta),
        use_relative=bool(use_relative), cfg=cfg, lcfg=lcfg, depth=depth,
        n=n, on_level=on_level, pbc=pbc)

    # used-row compaction (list_force.py:421-437): far ids become ranks in
    # a table of the used nodes; dead entries point at row U (zeros)
    M = level_offsets(n, depth)[-1]
    U = lcfg.used_cap
    live = torch.arange(far.shape[1], device=dev) < nf[:, None].long()
    used = torch.zeros(M + 1, dtype=torch.bool, device=dev)
    used[torch.where(live, far, M).reshape(-1).long()] = True
    used = used[:M]
    rank = torch.cumsum(used, 0, dtype=torch.int64) - 1
    n_used = rank[-1] + 1
    far_c = torch.where(live, torch.clamp(
        rank[torch.clamp(far, 0, M - 1).long()], max=U),
        torch.full_like(far, U, dtype=torch.int64)).to(torch.int32)
    dest = torch.where(used & (rank < U), rank, torch.full_like(rank, U))
    src = torch.zeros(U + 1, dtype=torch.int32, device=dev)
    src[dest] = torch.arange(M, dtype=torch.int32, device=dev)
    ovf = torch.cat([ovf, torch.clamp(n_used - U, min=0)[None]])
    need = torch.cat([need, n_used[None]])
    if vel is not None:
        vcom = node_velocities(tree, vel)
    else:
        vcom = torch.zeros_like(tree.mac_rows[:, 0:3])
    return InteractionLists(
        far=far_c.contiguous(), near=near.contiguous(), nf=nf, nn=nn,
        pidx=pidx, gvalid=gvalid, pos_ref=tree.pos_s, ovf=ovf, skin=skin,
        vcom=vcom, t_ref=torch.as_tensor(t_now, dtype=dtype, device=dev),
        src=src[:U].contiguous(), need=need)


def max_displacement(lists: InteractionLists, pos_sorted,
                     box: float = 0.0):
    """Max |pos - pos_ref| since record time (validity: <= skin/2), the
    JAX package's plain difference; ``box`` > 0: the minimum image of each
    displacement instead (what a particle wrapped onto the box since the
    record really moved)."""
    d = pos_sorted - lists.pos_ref
    if box:
        d = d - box * torch.round(d / box)
    return torch.sqrt(torch.max(torch.sum(d * d, dim=-1)))


def node_velocities(tree: Octree, vel):
    """(M, 3) mass-weighted mean velocity of every node, the reference's
    node drift velocity (forcetree.c ``vs``): per-level float64 segment
    sums of m v over the node's particles (as the tree's moments are
    summed), divided by the node mass."""
    n = tree.pos_s.shape[0]
    mv = vel[tree.perm].double() * tree.mass_s.double()[:, None]
    offs = level_offsets(n, tree.depth)
    parts = []
    for l in range(tree.depth + 1):
        cap = offs[l + 1] - offs[l]
        parts.append(torch.zeros(cap, 3, dtype=torch.float64,
                                 device=mv.device).index_add_(
            0, tree.seg_of[l], mv))
    s = torch.cat(parts)
    m = torch.clamp(tree.mac_rows[:, 3].double(), min=1e-30)
    return (s / m[:, None]).to(tree.pos_s.dtype)


def advance_tree(tree: Octree, lists: InteractionLists, pos_pred, t_now):
    """Per-step tree update between rebuilds: current sorted positions for
    the targets and the near pass, node centres of mass drifted by
    vcom (t_now - t_ref) from their rebuild values. Quadrupoles, eps and
    bmax stay at their rebuild values, as in the reference."""
    dt = (torch.as_tensor(t_now, dtype=tree.pos_s.dtype,
                          device=tree.pos_s.device) - lists.t_ref)
    mac = tree.mac_rows.clone()
    mac[:, 0:3] += lists.vcom * dt
    return dataclasses.replace(tree, pos_s=pos_pred[tree.perm].to(
        tree.pos_s.dtype), mac_rows=mac)


def eval_inputs(tree: Octree, lists: InteractionLists):
    """The far and near passes' inputs for the current ``tree``: the
    compact node table (used rows of the current node rows plus one zero
    row, by ``gather_nodes``), the raw targets (ng, G, 3), the
    group-centred targets, their softenings (1 on dead slots) and the group
    centres (0 for dead groups)."""
    M = tree.mac_rows.shape[0]
    src = torch.cat([lists.src, torch.full((1,), M, dtype=torch.int32,
                                           device=lists.src.device)])
    ctbl = gather_nodes(tree, src)
    pidx, gvalid = lists.pidx, lists.gvalid
    gtargets = tree.pos_s[pidx]
    big = torch.full((), 1e30, dtype=gtargets.dtype, device=gtargets.device)
    glo = torch.min(torch.where(gvalid[..., None], gtargets, big),
                    dim=1).values
    ghi = torch.max(torch.where(gvalid[..., None], gtargets, -big),
                    dim=1).values
    gc = torch.where(torch.any(gvalid, dim=1)[:, None], 0.5 * (glo + ghi),
                     torch.zeros_like(glo)).contiguous()
    xc = torch.where(gvalid[..., None], gtargets - gc[:, None, :],
                     torch.zeros_like(gtargets)).contiguous()
    te = torch.where(gvalid, tree.eps_s[pidx],
                     torch.ones_like(tree.eps_s[pidx])).contiguous()
    return ctbl, gtargets.contiguous(), xc, te, gc


def compact_traces(tree: Octree, lists: InteractionLists):
    """The compact table's raw quadrupole traces (the tree's ``trq`` of
    each used row, 0 for the zero row): the periodic far field's
    (``flat_tables``' ``tr_all[src]``, JAX list_force.py:722-723)."""
    zero = torch.zeros(1, dtype=tree.trq.dtype, device=tree.trq.device)
    return torch.cat([tree.trq[lists.src.long()], zero]).contiguous()


def eval_lists(tree: Octree, lists: InteractionLists, mass, eps, *,
               need_pot: bool = True, pbc=None):
    """Force and potential of every particle from recorded lists against
    the current node moments (``tree`` = the recording tree, refreshed or
    advanced). mass/eps in original order; returns (acc, pot) in original
    order, post-processed as the walk's are. ``pbc`` (box, alpha, rcut):
    the TreePM short range in a periodic box (JAX ``_eval`` :631-636,
    eval_lists :746-747): the far pass takes the raw targets and the
    compact table's traces (``far_list``'s periodic mode: a minimum image
    per pair, so a group straddling a face after a wrap still reads its
    nodes right), the near pass ``near_level``'s periodic mode, and the
    potential loses the near pass's self term 2 alpha/sqrt(pi) m."""
    ctbl, gtargets, xc, te, gc = eval_inputs(tree, lists)
    if pbc is not None:
        pbc = tuple(float(v) for v in pbc)
        a = far_list(ctbl, lists.far, lists.nf, gtargets,
                     te, torch.zeros_like(gc), need_pot=need_pot, pbc=pbc,
                     trq=compact_traces(tree, lists))
    else:
        a = far_list(ctbl, lists.far, lists.nf, xc, te, gc,
                     need_pot=need_pot)
    a = a + near_level(lists.near, lists.nn, tree.pos_s, tree.mass_s,
                       tree.eps_s, gtargets, te, need_pot=need_pot, pbc=pbc)
    acc, pot = ungroup(a[..., :3], a[..., 3], lists.pidx, lists.gvalid,
                       tree.perm, mass, eps, need_pot)
    if need_pot and pbc is not None:
        pot = pot - torch.where(mass > 0, mass, torch.zeros_like(mass)) \
            * (2.0 * pbc[1] / SQRT_PI)
    return acc, pot


_LIST_FIELDS = InteractionLists._fields


def lists_to_numpy(lists) -> dict:
    """Field name -> numpy array of the port's fields, for a port or a JAX
    ``InteractionLists``."""
    def arr(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    return {f: arr(getattr(lists, f)) for f in _LIST_FIELDS}


def lists_from_numpy(d: dict, device=None) -> InteractionLists:
    """The port's lists from numpy arrays (``lists_to_numpy`` of either
    package). The JAX package's telemetry has one more entry each
    (``ovf`` [.., mat-item], ``need`` [.., far items]) for its materialized
    far stream; those entries are dropped."""
    kw = {f: torch.as_tensor(np.asarray(d[f])).to(device)
          for f in _LIST_FIELDS}
    kw["ovf"] = kw["ovf"][:4].long()
    kw["need"] = kw["need"][:3].long()
    kw["pidx"] = kw["pidx"].long()
    return InteractionLists(**kw)
