"""The SIDM range walk's pieces (port of ``sidm_tpu/ops/fused_range.py``:
the range node rows of ``pack_range_tree`` :57, ``_range_classify`` :99
(in ``fused_force.range_classify``), ``_range_level_pass`` :257 (the range
mode of ``far_level``), ``cell_count_hsml_seed`` :596 and
``tree_hsml_init_fused`` :631 with the count of ``_sidm_near_tile``
:127-204).

The range walk is the force record walk with a range test in place of the
MAC: per target group, the cells whose box lies within the group's pad of
the group box are opened, leaves become segment keys ``start*32+cnt`` and
overfull deepest cells 16-particle chunk keys; cells out of range are
dropped. ``range_segments`` runs it level by level with ``far_level`` in
its range mode (the kernel on the card) and returns each group's segment
list in frontier order.

``tree_hsml_init_fused`` sets the initial SIDM smoothing lengths: a density
seed from tree cell counts, then ten passes of the multiplicative
neighbour-count controller and a last count. Each pass walks the groups
with pad = the largest h of the group and counts, per target, the
particles of its segments of the same type, not itself and not pending,
with sqrt(r^2) < h (``list_range.count_neighbours``, the count mode of the
emission kernel). JAX walks and counts without a segment cap; here the
segment lists are sized from the walk's own demand (one retry when the
guess was short), so every segment is counted. JAX's ``_range_eval`` also
computes the DSMC pair probabilities on the walk (the walk's DSMC path,
ROADMAP slice (b)); the count is all the init reads of it.

Layout: JAX's range rows are [centre xyz, count, node start, child start,
child count, 0]; the port's are the first 8 columns of a ``pack_tree`` row
with the geometric centre in place of the centre of mass and a zero mass,
[centre xyz, 0, count, node start, child start, child count], so that the
far kernel reads them with its own field offsets. JAX's 128-lane
``rows16`` particle packing is a TPU layout: the port keeps the (n, 8)
SIDM rows ``[pos3 vel3 mass aux]`` in sorted order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from .far_kernel import C_NEXT, S_NEED_N, S_OVF_L, S_OVF_N, far_level, \
    list_buf
from .fused_force import (LEAF_CAP, START_LEVEL, FusedConfig, make_windows,
                          w_schedule)
from .tree import Octree, level_offsets


def range_levels(tree: Octree) -> List[torch.Tensor]:
    """Per level (cap_l, 8) float32 range rows [geometric centre xyz, 0,
    count, node start, level-local child start, child count]."""
    n = tree.pos_s.shape[0]
    depth = tree.depth
    offs = level_offsets(n, depth)
    dtype = tree.pos_s.dtype
    out = []
    for l in range(depth + 1):
        sl = slice(offs[l], offs[l + 1])
        mac = tree.mac_rows[sl]
        child_local = tree.child_start[sl] - (offs[l + 1] if l < depth else 0)
        out.append(torch.cat([
            mac[:, 4:7], torch.zeros_like(mac[:, 7:8]), mac[:, 7:8],
            tree.node_start[sl, None].to(dtype),
            torch.clamp(child_local, min=0)[:, None].to(dtype),
            tree.child_count[sl, None].to(dtype)], dim=1).contiguous())
    return out


def range_segments(tree: Octree, rlev, glo, ghi, pad, *, seg_cap: int,
                   lvl_cap: Optional[int] = None,
                   cfg: Optional[FusedConfig] = None, on_level=None):
    """The range walk of every group (``_record_segments`` :94-202):
    segment and chunk keys appended in frontier order to (ng, seg_cap)
    lists under the level cap (None: none) and ``seg_cap``. Returns (keys,
    counts, ovf, need, stat): ovf the dropped entries (level, walk and list
    caps), need the largest per-group demand, stat the (5, ng) telemetry.
    on_level: optional observer ``on_level(level, kw)`` before every
    ``far_level`` call."""
    cfg = cfg or FusedConfig()
    n = tree.pos_s.shape[0]
    depth = tree.depth
    ng = glo.shape[0]
    dev = glo.device
    ws = w_schedule(cfg, depth, n, 0.5, True)
    buf = list_buf(ng, 0, seg_cap, dev)
    W0 = ws[START_LEVEL]
    fids = torch.arange(W0, dtype=torch.int32,
                        device=dev).repeat(ng, 1).contiguous()
    n_live = torch.full((ng,), W0, dtype=torch.int32, device=dev)
    for l in range(START_LEVEL, depth + 1):
        last = l == depth
        kw = dict(fids=fids, n_live=n_live, tbl=rlev[l],
                  nl_real=tree.n_nodes[l], s_l=tree.extent / (1 << l),
                  glo=glo, ghi=ghi, oac=pad, theta2=0.0, use_relative=False,
                  leaf_cap=LEAF_CAP, last=last, Wn=0 if last else ws[l + 1],
                  open_cap=cfg.open_cap, big_cap=cfg.big_cap,
                  big_chunks=cfg.big_chunks, lists=buf, lvl_base=0,
                  lvl_cap=lvl_cap, range_walk=True)
        if on_level is not None:
            on_level(l, kw)
        out = far_level(**kw)
        fids, n_live = out.fids, out.cnt[C_NEXT]
    stat = buf.stat.long()
    ovf = torch.sum(stat[S_OVF_L]) + torch.sum(stat[S_OVF_N])
    return buf.near, buf.nn, ovf, torch.max(stat[S_NEED_N]), stat


def group_targets(tree: Octree, pidx, gvalid, radius_sorted, type_sorted):
    """Per group slot: position, radius (0 on dead slots), type (-9 on dead
    slots) and sorted id (-1 on dead slots); per group the bounding box of
    the slots with a radius (dead groups parked far outside the tree) and
    the largest radius."""
    gt = tree.pos_s[pidx].contiguous()
    gr = torch.where(gvalid, radius_sorted[pidx],
                     torch.zeros_like(gt[..., 0])).contiguous()
    gty = torch.where(gvalid, type_sorted[pidx].to(torch.int32),
                      torch.full_like(pidx, -9, dtype=torch.int32))
    gidx = torch.where(gvalid, pidx, torch.full_like(pidx, -1)).to(
        torch.int32)
    big = torch.full((), 1e30, dtype=gt.dtype, device=gt.device)
    live_t = gvalid & (gr > 0)
    glo = torch.min(torch.where(live_t[..., None], gt, big), dim=1).values
    ghi = torch.max(torch.where(live_t[..., None], gt, -big), dim=1).values
    any_v = torch.any(live_t, dim=1)
    far_here = tree.origin + 4.0 * tree.extent
    glo = torch.where(any_v[:, None], glo, far_here).contiguous()
    ghi = torch.where(any_v[:, None], ghi, far_here).contiguous()
    gmax = torch.max(torch.where(live_t, gr, torch.zeros_like(gr)),
                     dim=1).values
    return gt, gr, gty.contiguous(), gidx.contiguous(), glo, ghi, gmax


def cell_count_hsml_seed(tree: Octree, k: int):
    """Per-particle smoothing-length seed in ORIGINAL order: the deepest
    ancestor cell with >= 2k particles gives a number density, h =
    s_cell (3k / (4 pi count))^(1/3) (forcetree.c:2326-2347 analog).

    JAX finds each sorted particle's cell at a level by a running maximum
    over the cells' start marks, i.e. the last cell with particles that
    starts at or before it; that is the cell the tree's ``seg_of`` names
    for a valid particle, and for the padding slots (sorted after every
    valid particle) the last valid particle's cell. The same cells are
    read here from ``seg_of`` (a running maximum over 1e6 int64 costs
    ~2.7 ms per level on the H100)."""
    n = tree.pos_s.shape[0]
    dtype, dev = tree.pos_s.dtype, tree.pos_s.device
    offs = level_offsets(n, tree.depth)
    s_sel = torch.full((n,), 1.0, dtype=dtype, device=dev) * tree.extent
    c_sel = torch.full((n,), float(n), dtype=dtype, device=dev)
    nv = int(tree.node_count[0])          # the root holds every valid one
    idx = torch.clamp(torch.arange(n, device=dev), max=max(nv - 1, 0))
    for l in range(1, tree.depth + 1):
        if nv == 0:
            break
        nid = offs[l] + tree.seg_of[l][idx]
        c_p = tree.node_count[nid].to(dtype)
        ok = c_p >= 2 * k
        s_sel = torch.where(ok, tree.extent / (1 << l), s_sel)
        c_sel = torch.where(ok, c_p, c_sel)
    h_sorted = s_sel * (3.0 * k / ((4.0 * math.pi) * c_sel)) ** (1.0 / 3.0)
    out = torch.empty_like(h_sorted)
    out[tree.perm] = h_sorted
    return out


def tree_hsml_init_fused(p, tree: Octree, k: int, iters: int = 10,
                         cfg: Optional[FusedConfig] = None,
                         seg_cap: int = 8192):
    """Initial smoothing lengths (setup_smoothinglengths_sidm analog,
    init.c:159): the cell-count seed, then ``iters`` counting passes of
    the controller h *= clip((k/cnt)^(1/3), 0.5, 2) (capped at 8x the
    median), and a last count at the final h. Returns the particles with
    ``hsml_vd`` and ``ngb_vd`` set for the collisionless ones."""
    from .list_range import count_neighbours, sidm_sources
    from .sidm_tree import nanmedian

    n = tree.pos_s.shape[0]
    dtype = tree.pos_s.dtype
    col = p.is_collisionless & p.valid
    h = cell_count_hsml_seed(tree, k)
    h = torch.where(col, h, torch.zeros_like(h))
    hcap = 8.0 * nanmedian(torch.where(col, h, torch.full_like(h,
                                                               float("nan"))))
    hcap = torch.nan_to_num(hcap, nan=float("inf"))

    def cap(hh):
        return torch.where(col, torch.minimum(hh, hcap), hh)

    h = cap(h)
    perm = tree.perm
    typs_s = torch.where(col, p.ptype, torch.full_like(p.ptype, -9))[perm]
    aux = torch.clamp(p.ptype, 0, 7).to(dtype)[perm]
    src = sidm_sources(tree.pos_s, aux)
    rlev = range_levels(tree)
    pidx, gvalid = make_windows(tree.keys_s, p.valid[perm], n, tree.depth)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=perm.device)
    cnt_flat = torch.zeros(n, dtype=torch.int32, device=h.device)
    for it in range(iters + 1):
        gt, gh, gty, gidx, glo, ghi, pad = group_targets(
            tree, pidx, gvalid, h[perm], typs_s)
        while True:
            keys, nn, _, need, stat = range_segments(
                tree, rlev, glo, ghi, pad, seg_cap=seg_cap, cfg=cfg)
            if int(torch.sum(stat[S_OVF_N])) == 0:
                break
            seg_cap = -(-int(need) // 1024) * 1024
        cnt_sorted = count_neighbours(keys, nn, src, gt, gh, gty, gidx, n)
        cnt_flat = cnt_sorted[inv]
        if it < iters:
            ratio = (k / torch.clamp(cnt_flat, min=1).to(dtype)) ** (1.0 / 3.0)
            h = cap(torch.where(col, h * torch.clamp(ratio, 0.5, 2.0), h))
    return dataclasses.replace(
        p, hsml_vd=torch.where(col, h, p.hsml_vd),
        ngb_vd=torch.where(col, cnt_flat, p.ngb_vd).to(torch.int32))
