"""Work-queue Barnes-Hut gravity (port of ``sidm_tpu/ops/wq_force.py``:
``wq_gravity_tree`` :547, ``wq_gravity`` :610, the level loop of
``_wq_eval`` :401-544 with its ``pbc`` plumbing :102-212, :280-340;
``_expand_open_wq`` :357 is in ``far_kernel``).

``pbc`` = (box, alpha, rcut) gives the TreePM split's short range in a
periodic box (``ops/pm.py`` the long range): the tree is built on the box
as its root cube, dead groups are parked with an inverted huge box, and the
three kernels run their periodic modes (the minimum image; the walk drops
what lies beyond ``rcut``; the screened far field from the raw targets
with the exact screened quadrupole; the screened near pairs). The
potential loses the near pass's self term 2 alpha/sqrt(pi) m (JAX
:601-602). With ``pbc`` = (0, alpha, rcut), ``PMVacuum``'s split of an
isolated run, the tree is built free, dead groups are parked outside it,
and the kernels run their free-space modes (no minimum image).

``ewald`` (an ``ops/ewald.EwaldTable``, ``PMGrid -1``): the per-pair Ewald
walk of ``sidm_tpu/ops/treeforce.py`` (its ``ewald`` argument) on this
walk: the tree built on the table's box, the periodic classification with
``fused_force.ewald_pbc`` (no cut), and the far and near passes' Ewald
modes (the minimum-image Newtonian field plus every pair's Ewald
correction, the node-level correction of forcetree.c:1572 on the far
nodes, whose potential also takes the isotropic second-order term of the
correction, ROADMAP.md C.21). The potential keeps the self pair's psi(0) m
(JAX's ``tree_gravity`` :569-571). The pair sets are the wq walk's, not
treeforce's ``global_walk``'s (ROADMAP C).

Same walk and the same accepted pair sets as the JAX engine: for every
64-target group a per-level frontier of node ids is classified against the
group bounding box, accepted multipoles are evaluated at discovery, opened
leaves become segment keys evaluated by the near pass of the same level,
opened inner cells expand x8 into the next frontier, and overfull deepest
cells go through the 16-particle-chunk "big" path. Each level is one
``far_level`` call (the port of the Pallas far kernel's classification: it
hands back the compacted far ids and segment keys, the next frontier and
the counts), one ``far_list`` call on the compacted far ids (the far
field, which the Pallas kernel fuses into its classification) and one
``near_level`` call (the port of the Pallas near kernel); on CUDA tensors
all three launch the package's CUDA kernels.

The caps that define the accepted pair sets are kept and their overflow is
counted exactly as in JAX (``w_max``: frontier truncation and ``open_cap``
into ``ovf_open``; ``big_cap``/``big_chunks`` into ``ovf_big``). The JAX
engine's static item caps and super-block loops have no counterpart: each
kernel walks a group's whole frontier, so ``ovf_items`` is always 0 and
``max_walk_items``/``max_near_items`` report the (group, chunk) item counts
the JAX engine would have scheduled.
"""

from __future__ import annotations

from typing import Optional

import torch

from .far_kernel import (C_BIG, C_BIG_DROP, C_BK, C_FAR, C_NEXT, C_OPEN,
                         C_OVF_OPEN, C_SEG, far_level)
from .far_list import far_list
from .fused_force import (LEAF_CAP, SC, START_LEVEL, WC, FusedConfig,
                          FusedTree, default_depth, ewald_pbc, make_windows,
                          pack_tree, w_schedule)
from .near_kernel import near_level
from .pm import SQRT_PI
from .tree import build_octree


def _near_items(n_seg, width: int):
    return torch.sum(-(-n_seg // min(SC, width)))


def _wq_eval(ftree: FusedTree, tree, gtargets, geps, glo, ghi, oac, gvalid,
             theta: float, use_relative: bool, cfg: FusedConfig,
             need_pot: bool, on_level=None, pbc=None, ewald=None):
    """The walk + evaluation over all levels. Returns per-group
    acc (ng, G, 3), pot (ng, G) and the info dict (0-dim tensors).
    ``ewald``: the Ewald walk (``pbc`` unread).

    on_level: optional observer called as ``on_level(name, level, kw)``
    before every ``far_level``/``far_list``/``near_level`` call with the
    call's keyword arguments (the big path's near call has level
    depth + 1)."""
    ng, G, _ = gtargets.shape
    dev, dtype = gtargets.device, gtargets.dtype
    depth = tree.depth
    n = tree.pos_s.shape[0]
    theta2 = theta * theta
    gtargets = gtargets.contiguous()
    walk_pbc = ewald_pbc(ewald.box) if ewald is not None else pbc
    if walk_pbc is not None:
        # the periodic, free-space and Ewald far fields difference raw
        # targets per pair
        gc = torch.zeros_like(glo)
        xc = gtargets
    else:
        gc = 0.5 * (glo + ghi)
        xc = torch.where(gvalid[..., None], gtargets - gc[:, None, :],
                         torch.zeros_like(gtargets)).contiguous()
    ws = w_schedule(cfg, depth, n, theta, use_relative)
    l0 = START_LEVEL

    acc = torch.zeros(ng, G, 3, dtype=dtype, device=dev)
    pot = torch.zeros(ng, G, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    ovf_open, ovf_big, n_segs = zero, zero, zero
    max_walk, max_near = zero, zero
    max_open = []
    fids = torch.arange(ws[l0], dtype=torch.int32,
                        device=dev).repeat(ng, 1).contiguous()
    n_live = torch.full((ng,), ws[l0], dtype=torch.int32, device=dev)

    def call(fn, level, **kw):
        if on_level is not None:
            on_level(fn.__name__, level, kw)
        return fn(**kw)

    def near(keys, n_seg, width, level):
        nonlocal acc, pot, max_near
        a = call(near_level, level, keys=keys.contiguous(), n_seg=n_seg,
                 pos_s=tree.pos_s, mass_s=tree.mass_s, eps_s=tree.eps_s,
                 xr=gtargets, te=geps, need_pot=need_pot, pbc=pbc,
                 ewald=ewald)
        acc = acc + a[..., :3]
        if need_pot:
            pot = pot + a[..., 3]
        max_near = torch.maximum(max_near, _near_items(n_seg, width))

    for l in range(l0, depth + 1):
        W = ws[l]
        last = l == depth
        s_l = tree.extent / (1 << l) + 2.0 * tree.drift
        out = call(
            far_level, l, fids=fids, n_live=n_live, tbl=ftree.levels[l],
            nl_real=ftree.n_levels[l], s_l=s_l, glo=glo, ghi=ghi, oac=oac,
            theta2=theta2, use_relative=use_relative, leaf_cap=LEAF_CAP,
            last=last, Wn=0 if last else ws[l + 1], open_cap=cfg.open_cap,
            big_cap=cfg.big_cap, big_chunks=cfg.big_chunks, pbc=walk_pbc)
        a = call(far_list, l, tbl=ftree.levels[l], ids=out.far,
                 nf=out.cnt[C_FAR], xc=xc, te=geps, gc=gc,
                 need_pot=need_pot, pbc=pbc,
                 trq=ftree.levels_tr[l] if walk_pbc is not None else None,
                 ewald=ewald)
        acc = acc + a[..., :3]
        if need_pot:
            pot = pot + a[..., 3]
        wc = min(WC, W)
        max_walk = torch.maximum(max_walk, torch.sum(
            -(-torch.clamp(n_live.long(), max=W) // wc)))
        n_seg = out.cnt[C_SEG]
        n_segs = n_segs + torch.sum(n_seg)
        near(out.seg, n_seg, W, l)
        if not last:
            fids, n_live = out.fids, out.cnt[C_NEXT]
            ovf_open = ovf_open + torch.sum(out.cnt[C_OVF_OPEN])
            max_open.append(torch.max(out.cnt[C_OPEN]))

    # overfull deepest cells -> 16-particle chunks, same near pass
    n_bk = out.cnt[C_BK]
    n_segs = n_segs + torch.sum(n_bk)
    near(out.bkey, n_bk, out.bkey.shape[1], depth + 1)
    ovf_big = (torch.sum(torch.clamp(out.cnt[C_BIG] - cfg.big_cap, min=0))
               + torch.sum(out.cnt[C_BIG_DROP]))

    info = dict(ovf_open=ovf_open, ovf_big=ovf_big, ovf_items=zero,
                max_walk_items=max_walk, max_near_items=max_near,
                n_segs=n_segs,
                max_open=(torch.stack(max_open) if max_open
                          else torch.zeros(1, dtype=torch.int32,
                                           device=dev)))
    return acc, pot, info


def group_boxes(tree, gtargets, gvalid, goac, skin=0.0, periodic=False):
    """Per group: the bounding box of its valid targets grown by ``skin``
    (dead groups: parked far outside the tree, so nothing opens; with
    ``periodic`` an inverted huge box, since the minimum image would bring
    a parked box back into the periodic one) and the smallest positive
    relative-criterion threshold (0 if none)."""
    big = torch.full((), 1e30, dtype=gtargets.dtype, device=gtargets.device)
    glo = torch.min(torch.where(gvalid[..., None], gtargets, big),
                    dim=1).values - skin
    ghi = torch.max(torch.where(gvalid[..., None], gtargets, -big),
                    dim=1).values + skin
    any_v = torch.any(gvalid, dim=1)
    if periodic:
        glo = torch.where(any_v[:, None], glo, 1e18).contiguous()
        ghi = torch.where(any_v[:, None], ghi, -1e18).contiguous()
    else:
        far_here = tree.origin + 4.0 * tree.extent
        glo = torch.where(any_v[:, None], glo, far_here).contiguous()
        ghi = torch.where(any_v[:, None], ghi, far_here).contiguous()
    pos_oac = gvalid & (goac > 0)
    oac = torch.min(torch.where(pos_oac, goac, big), dim=1).values
    oac = torch.where(torch.any(pos_oac, dim=1), oac,
                      torch.zeros_like(oac)).contiguous()
    return glo, ghi, oac


def wq_gravity_tree(tree, mass, eps, old_acc, *, theta=0.5, opening=1,
                    err_tol_force_acc=0.005,
                    config: Optional[FusedConfig] = None,
                    return_info: bool = False, need_pot: bool = True,
                    on_level=None, pbc=None, ewald=None):
    """Work-queue walk/eval on a prebuilt octree. mass/eps/old_acc are in
    original particle order; returns raw (acc, pot[, info]) in original
    order (no G factor; the spline self potential removed). on_level: see
    ``_wq_eval``; ``pbc`` (box, alpha, rcut): the TreePM short range in a
    periodic box (the tree built with ``box``), or box 0 in free space;
    ``ewald``: the Ewald walk in the table's box (the tree built on it;
    ``pbc`` unread)."""
    if ewald is not None:
        pbc = None
    cfg = config or FusedConfig()
    n = tree.pos_s.shape[0]
    dtype = tree.pos_s.dtype
    valid = mass > 0
    ftree = pack_tree(tree)
    pidx, gvalid = make_windows(tree.keys_s, valid[tree.perm], n,
                                tree.depth)
    toac = old_acc[tree.perm] * err_tol_force_acc
    gtargets = tree.pos_s[pidx]
    geps = torch.where(gvalid, tree.eps_s[pidx],
                       torch.ones((), dtype=dtype, device=pidx.device))
    goac = torch.where(gvalid, toac[pidx], torch.zeros_like(toac[pidx]))
    glo, ghi, oac = group_boxes(
        tree, gtargets, gvalid, goac,
        periodic=ewald is not None or (pbc is not None and pbc[0] > 0))
    if pbc is not None:
        pbc = tuple(float(v) for v in pbc)

    acc_g, pot_g, info = _wq_eval(ftree, tree, gtargets, geps.contiguous(),
                                  glo, ghi, oac, gvalid, float(theta),
                                  bool(opening == 1), cfg, bool(need_pot),
                                  on_level, pbc, ewald)

    acc, pot = ungroup(acc_g, pot_g, pidx, gvalid, tree.perm, mass, eps,
                       need_pot)
    if need_pot and pbc is not None:
        pot = pot - torch.where(mass > 0, mass, torch.zeros_like(mass)) \
            * (2.0 * pbc[1] / SQRT_PI)
    if return_info:
        return acc, pot, info
    return acc, pot


def ungroup(acc_g, pot_g, pidx, gvalid, perm, mass, eps, need_pot: bool):
    """Per-group results -> (acc, pot) in the original particle order:
    slots back to sorted order (a dump row for dead slots), then through
    the tree's permutation; the spline self potential is removed
    (potential.c:136) and invalid particles get zeros."""
    n = perm.shape[0]
    dtype, dev = acc_g.dtype, acc_g.device
    valid = mass > 0
    didx = torch.where(gvalid, pidx, torch.full_like(pidx, n)).reshape(-1)
    acc_s = torch.zeros(n + 1, 3, dtype=dtype, device=dev)
    acc_s[didx] = acc_g.reshape(-1, 3)
    pot_s = torch.zeros(n + 1, dtype=dtype, device=dev)
    pot_s[didx] = pot_g.reshape(-1)
    acc = torch.empty(n, 3, dtype=dtype, device=dev)
    acc[perm] = acc_s[:n]
    pot = torch.empty(n, dtype=dtype, device=dev)
    pot[perm] = pot_s[:n]
    if need_pot:
        pot = pot + mass / torch.clamp(eps, min=1e-30)
        pot = torch.where(valid, pot, torch.zeros_like(pot))
    acc = torch.where(valid[:, None], acc, torch.zeros_like(acc))
    return acc, pot


def wq_gravity(pos, mass, eps, old_acc, *, theta=0.5, opening=1,
               err_tol_force_acc=0.005, depth: Optional[int] = None,
               config: Optional[FusedConfig] = None,
               return_info: bool = False, need_pot: bool = True,
               pbc=None, ewald=None):
    """Raw acceleration/potential for all particles (wq engine): builds the
    octree (on the periodic box with ``pbc``, on the table's box with
    ``ewald``), then ``wq_gravity_tree``."""
    n = pos.shape[0]
    if depth is None:
        depth = default_depth(n)
    if n > (1 << 24):
        raise ValueError("wq engine packs indices as exact f32; "
                         "N must be <= 2^24")
    box = (float(ewald.box) if ewald is not None
           else float(pbc[0]) if pbc is not None else 0.0)
    tree = build_octree(pos, mass, eps, mass > 0, depth=depth, box=box)
    return wq_gravity_tree(
        tree, mass, eps, old_acc, theta=theta, opening=opening,
        err_tol_force_acc=err_tol_force_acc, config=config,
        return_info=return_info, need_pot=need_pot, pbc=pbc, ewald=ewald)
