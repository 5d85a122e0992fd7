"""The SIDM range walk and the DSMC engine on it (port of
``sidm_tpu/ops/fused_range.py``: the range node rows of
``pack_range_tree`` :57, ``_range_classify`` :99 (in
``fused_force.range_classify``), ``_range_level_pass`` :257 (the range
mode of ``far_level``), ``_sidm_near_tile`` :127 and ``_sidm_near_level``
:207 (``sidm_near``), ``make_gated_windows`` :432, ``sidm_scatter_fused``
:462, ``cell_count_hsml_seed`` :596 and ``tree_hsml_init_fused`` :631).

The range walk is the force record walk with a range test in place of the
MAC: per target group, the cells whose box lies within the group's pad of
the group box are opened, leaves become segment keys ``start*32+cnt`` and
overfull deepest cells 16-particle chunk keys; cells out of range are
dropped. ``range_segments`` walks every level of every group and returns
each group's segment list in frontier order: on the card in one launch
of its kernel (``csrc/range_walk.cu``), on the CPU by its plain version
``range_walk_plain``, level by level with ``far_level_plain`` in its range
mode. With a periodic ``box`` every distance is the minimum image and the
tree is built on the box.

``sidm_scatter_fused`` is the DSMC pass on the walk (the engine of
``SIDMOn 1`` with ``ListMode 0``, and of the list cadence once its
candidate or force lists are given up): the gated targets in their own
Morton windows, their range walk at pad = the group's largest h plus the
refresh drift, and ``sidm_near`` (the kernel ``csrc/sidm_near.cu`` on the
card) over the walked segments. JAX interleaves the pair pass with the
walk, level by level; the pairs are the union over the levels, so the
port walks first and runs one pass over each group's whole segment list.
JAX's partner on an exact key tie depends on its chunking (the first
chunk's wins); here the larger sorted id wins, as in the gated tile.

``tree_hsml_init_fused`` sets the initial SIDM smoothing lengths: a density
seed from tree cell counts, then ten passes of the multiplicative
neighbour-count controller and a last count. Each pass walks the groups
with pad = the largest h of the group and counts, per target, the
particles of its segments of the same type, not itself and not pending,
with sqrt(r^2) < h (``list_range.count_neighbours``, the count mode of the
emission kernel). JAX walks and counts without a segment cap; here the
segment lists are sized from the walk's own demand (one retry when the
guess was short), and a walk that drops cells past its caps is walked
again with larger caps, so every segment is counted; the walk engine does
the same. (JAX's walks drop such cells silently; at N = 1e6 the gated
targets' windows of flagship-dsmc-walk span wide boxes whose frontiers
overflow the default ``open_cap`` and ``w_max``.)

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

from ..kernels import sph_kernel
from ..sidm_common import sigma_v_product
from .far_kernel import (BIG_MAX, C_BIG, C_BIG_DROP, C_NEXT, C_OVF_OPEN,
                         S_NEED_N, S_OVF_L, S_OVF_N, far_level,
                         far_level_plain, list_buf)
from .fused_force import (G, IMAX, LEAF_CAP, START_LEVEL, FusedConfig,
                          make_windows, min_image, w_schedule)
from .morton import SENTINEL
from .sidm import SidmParams
from .sidm_tree import pair_gumbel, tree_sidm_finish, tree_sidm_prep
from .tree import Octree, level_offsets


@dataclasses.dataclass(frozen=True)
class RangeRows:
    """The range rows of every level in one table: ``table`` (M, 8)
    float32 [geometric centre xyz, hmax, count, node start, level-local
    child start, child count], level l at rows ``offs[l]:offs[l + 1]``
    (``level_offsets``); ``rows[l]`` is that level's view. hmax is 0
    unless ``range_levels`` was given smoothing lengths."""
    table: torch.Tensor
    offs: List[int]

    def __getitem__(self, l: int) -> torch.Tensor:
        return self.table[self.offs[l]:self.offs[l + 1]]


def range_levels(tree: Octree, hmax_sorted=None) -> RangeRows:
    """The range rows of every level (``RangeRows``), built in one pass
    over the tree's node arrays. hmax_sorted: optional (N,) smoothing
    lengths in sorted order (0 where a particle has none); each node's
    hmax is then their largest over its Morton segment (JAX's sparse-table
    range max, ``sidm_tpu/ops/fused_sph.py:pack_sph_tree`` :79-91: the
    particles of a node are one contiguous run, so it is the same number),
    0 for a node with no particle."""
    n = tree.pos_s.shape[0]
    depth = tree.depth
    offs = level_offsets(n, depth)
    M = offs[-1]
    dtype, dev = tree.pos_s.dtype, tree.pos_s.device
    mac = tree.mac_rows[:M]
    hmax = torch.zeros_like(mac[:, 7:8])
    if hmax_sorted is not None:
        # a segment max per level: each particle's node is seg_of's (the
        # particles without a smoothing length add 0)
        for l in range(depth + 1):
            hmax[offs[l]:offs[l + 1], 0].scatter_reduce_(
                0, tree.seg_of[l], hmax_sorted.to(dtype), "amax")
    # each node's next level offset: children are level-local
    nxt = torch.repeat_interleave(
        torch.tensor([offs[l + 1] if l < depth else 0
                      for l in range(depth + 1)], device=dev),
        torch.tensor([offs[l + 1] - offs[l] for l in range(depth + 1)],
                     device=dev), output_size=M)
    child_local = torch.clamp(tree.child_start[:M] - nxt, min=0)
    table = torch.cat([
        mac[:, 4:7], hmax, mac[:, 7:8],
        tree.node_start[:M, None].to(dtype), child_local[:, None].to(dtype),
        tree.child_count[:M, None].to(dtype)], dim=1).contiguous()
    return RangeRows(table, offs)


# rows of the range walk kernel's telemetry past stat's five
# (far_kernel.S_*): the walk's cap drops per group (csrc/range_walk.cu
# kOpen ... kBigDrop); and its totals (kSumOvf ... kSumBigDrop)
N_TELE = 8
R_OVF, R_NEED, R_OPEN, R_BIG_OVER, R_BIG_DROP = range(5)
RANGE_SHARED_IDS = 256   # frontier ids per group kept in shared memory
                         # (csrc/range_walk.cu kFS)


def range_walk_plain(tree: Octree, rlev: RangeRows, glo, ghi, pad, *,
                     seg_cap: int, lvl_cap: Optional[int] = None,
                     cfg: Optional[FusedConfig] = None, box: float = 0.0,
                     on_level=None, drops: Optional[dict] = None,
                     use_hmax: bool = False):
    """Plain PyTorch version of ``range_segments``: the walk level by
    level, each level a ``far_level_plain`` call in its range mode.
    on_level: optional observer ``on_level(level, kw)`` before every
    level's call."""
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
    opened = torch.zeros((), dtype=torch.long, device=dev)
    for l in range(START_LEVEL, depth + 1):
        last = l == depth
        kw = dict(fids=fids, n_live=n_live, tbl=rlev[l],
                  nl_real=tree.n_nodes[l], s_l=tree.extent / (1 << l),
                  glo=glo, ghi=ghi, oac=pad, theta2=0.0, use_relative=False,
                  leaf_cap=LEAF_CAP, last=last, Wn=0 if last else ws[l + 1],
                  open_cap=cfg.open_cap, big_cap=cfg.big_cap,
                  big_chunks=cfg.big_chunks, lists=buf, lvl_base=0,
                  lvl_cap=lvl_cap, range_walk=True, box=box,
                  use_hmax=use_hmax, drift=tree.drift)
        if on_level is not None:
            on_level(l, kw)
        out = far_level_plain(**kw)
        fids, n_live = out.fids, out.cnt[C_NEXT]
        if drops is not None:
            opened = opened + torch.sum(out.cnt[C_OVF_OPEN].long())
            if last:
                drops.update(open=opened, big_over=torch.sum(torch.clamp(
                    out.cnt[C_BIG].long() - cfg.big_cap, min=0)),
                    big_drop=torch.sum(out.cnt[C_BIG_DROP].long()))
    stat = buf.stat.long()
    ovf = torch.sum(stat[S_OVF_L]) + torch.sum(stat[S_OVF_N])
    need = torch.max(torch.cat([stat[S_NEED_N], stat.new_zeros(1)]))
    return buf.near, buf.nn, ovf, need, stat


def range_segments(tree: Octree, rlev: RangeRows, glo, ghi, pad, *,
                   seg_cap: int, lvl_cap: Optional[int] = None,
                   cfg: Optional[FusedConfig] = None, box: float = 0.0,
                   on_level=None, drops: Optional[dict] = None,
                   shared_ids: int = RANGE_SHARED_IDS,
                   use_hmax: bool = False):
    """The range walk of every group (``_record_segments`` :94-202):
    segment and chunk keys appended in frontier order to (ng, seg_cap)
    lists (IMAX past each count) under the level cap (None: none) and
    ``seg_cap``; ``box`` > 0: minimum-image distances in the periodic box.
    rlev: ``range_levels(tree)``; glo, ghi (ng, 3) group boxes, pad (ng,).
    Returns (keys, counts, ovf, need, stat): ovf the dropped entries
    (level, walk and list caps), need the largest per-group demand, stat
    the (5, ng) int64 telemetry (``far_kernel.S_*``). drops: optional dict
    that receives the walk's cap drops as 0-d tensors: ``open`` (cells past
    ``open_cap`` and children past the frontier width, summed over the
    levels), ``big_over`` (overfull deepest cells past ``big_cap``) and
    ``big_drop`` (particles past ``big_chunks`` chunks of those cells; JAX's
    walk counts them in ``ovf_big``, its list record does not).
    ``use_hmax``: the hydro walk of the tree SPH engine (kernel T1, the
    hmax mode of the same kernel, counted in ``far_level.
    range_hmax_launches``): a cell is in range within max(pad, hmax +
    tree.drift) of the group box, hmax the rows' column 3
    (``range_levels(tree, hmax_sorted)``).

    On a CUDA tensor one launch of ``csrc/range_walk.cu`` walks every
    level of every group (counted in ``far_level.range_launches``); its
    frontiers stay in shared memory, each group's first ``shared_ids`` ids
    a level (at most RANGE_SHARED_IDS; fewer send more of them through a
    global scratch row, which tests use to force that path). On a CPU
    tensor ``range_walk_plain`` runs, whose ``on_level`` observes each
    level (the kernel has no levels to observe: a CUDA walk with
    ``on_level`` raises)."""
    if not glo.is_cuda:
        return range_walk_plain(tree, rlev, glo, ghi, pad, seg_cap=seg_cap,
                                lvl_cap=lvl_cap, cfg=cfg, box=box,
                                on_level=on_level, drops=drops,
                                use_hmax=use_hmax)
    if on_level is not None:
        raise ValueError("range_segments: on_level observes the plain walk "
                         "(range_walk_plain) only")
    from .._build import check_cuda, int_array, kernels_lib, launch_args
    cfg = cfg or FusedConfig()
    n = tree.pos_s.shape[0]
    depth = tree.depth
    ng = glo.shape[0]
    dev = glo.device
    if cfg.big_cap > BIG_MAX:
        raise ValueError(f"range_segments: big_cap {cfg.big_cap} > "
                         f"{BIG_MAX}")
    if not 0 <= shared_ids <= RANGE_SHARED_IDS:
        raise ValueError(f"range_segments: shared_ids {shared_ids} not in "
                         f"[0, {RANGE_SHARED_IDS}]")
    check_cuda("range_segments",
               table=(rlev.table, torch.float32, (rlev.offs[-1], 8)),
               extent=(tree.extent, torch.float32, ()),
               glo=(glo, torch.float32, (ng, 3)),
               ghi=(ghi, torch.float32, (ng, 3)),
               pad=(pad, torch.float32, (ng,)),
               drift=(tree.drift, torch.float32, ()))
    ws = w_schedule(cfg, depth, n, 0.5, True)
    w = [ws.get(l, 0) for l in range(depth + 1)]
    sw = max([0] + w[START_LEVEL + 1:]) - shared_ids
    i32 = dict(dtype=torch.int32, device=dev)
    keys = torch.empty(ng, seg_cap, **i32)
    nn = torch.empty(ng, **i32)
    tele = torch.empty(N_TELE, ng, dtype=torch.long, device=dev)
    tot = torch.empty(5, dtype=torch.long, device=dev)
    scratch = torch.empty(2, ng, max(sw, 0), **i32)
    err = kernels_lib().range_walk_launch(*launch_args(
        rlev.table, int_array(rlev.offs[:depth + 1]),
        int_array(tree.n_nodes[:depth + 1]), int_array(w), START_LEVEL,
        depth, tree.extent, glo, ghi, pad, ng, float(box), float(LEAF_CAP),
        int(cfg.open_cap), int(cfg.big_cap), int(cfg.big_chunks),
        -1 if lvl_cap is None else int(lvl_cap), int(seg_cap), keys, nn,
        tele, tot, scratch, max(sw, 0), int(shared_ids),
        tree.drift if use_hmax else None))
    if err:
        raise RuntimeError(f"range_segments kernel launch failed: CUDA "
                           f"error {err}")
    if use_hmax:
        far_level.range_hmax_launches += 1
    else:
        far_level.range_launches += 1
    if drops is not None:
        drops.update(open=tot[R_OPEN], big_over=tot[R_BIG_OVER],
                     big_drop=tot[R_BIG_DROP])
    return keys, nn, tot[R_OVF], tot[R_NEED], tele[:S_OVF_N + 1]


def segment_particles(keys, nn):
    """Per group the particles of its live segment keys, in key order
    then particle order: (sorted ids (B, P) int64, valid (B, P))."""
    B, L = keys.shape
    dev = keys.device
    live = (torch.arange(L, device=dev)[None, :] < nn[:, None].long()) \
        & (keys != IMAX)
    k = torch.where(live, keys, torch.zeros_like(keys)).long()
    cnt = torch.where(live, k & 31, torch.zeros_like(k))
    cum = torch.cumsum(cnt, dim=1)
    tot = cum[:, -1] if L else torch.zeros(B, dtype=torch.long, device=dev)
    P = int(tot.max()) if B else 0
    pp = torch.arange(P, device=dev).expand(B, P).contiguous()
    seg = torch.clamp(torch.searchsorted(cum, pp, right=True), max=L - 1)
    ex = (cum - cnt).gather(1, seg)
    idx = (k >> 5).gather(1, seg) + pp - ex
    val = pp < tot[:, None]
    return torch.where(val, idx, torch.zeros_like(idx)), val


def segment_totals_plain(keys, nn):
    """Plain PyTorch version of ``segment_totals``."""
    live = (torch.arange(keys.shape[1], device=keys.device)[None, :]
            < nn[:, None].long()) & (keys != IMAX)
    return torch.sum(torch.where(live, keys & 31, 0), dim=1).to(torch.int32)


def segment_totals(keys, nn):
    """(ng,) int32: per group the particles its live segment keys cover
    (keys (ng, L) int32 ``start*32+cnt`` with live counts nn (ng,); IMAX
    keys cover none), the particles ``sidm_emit`` and ``sidm_near`` stage
    for it. Kernel ``cover_count`` (``csrc/work_items.cuh``, launched from
    ``csrc/near_kernel.cu``) on a CUDA tensor."""
    if not keys.is_cuda:
        return segment_totals_plain(keys, nn)
    from .._build import check_cuda, kernels_lib, launch_args
    ng, L = keys.shape
    check_cuda("segment_totals", keys=(keys, torch.int32, (ng, L)),
               nn=(nn, torch.int32, (ng,)))
    tot = torch.empty(ng, dtype=torch.int32, device=keys.device)
    err = kernels_lib().segment_totals_launch(*launch_args(keys, nn, ng, L,
                                                           tot))
    if err:
        raise RuntimeError(f"segment_totals kernel launch failed: CUDA "
                           f"error {err}")
    segment_totals.launches += 1
    return tot


segment_totals.launches = 0


def group_order(keys, nn):
    """(ng,) int32 launch order of the emission's groups: the most staged
    particles (``segment_totals``) first, ties in index order, so that the
    longest groups do not start last (JAX length-sorts its groups for the
    emission, ``sidm_tpu/ops/list_range.py:230``)."""
    return torch.argsort(segment_totals(keys, nn), descending=True,
                         stable=True).to(torch.int32)


def live_slots(gidx, gh):
    """(ng,) int32: per group its live slots, those with a target (gidx >=
    0) and a radius (gh > 0): the slots ``sidm_near``'s kernel gives
    threads (the others only get (0, 0, -inf, -1))."""
    return torch.sum((gidx >= 0) & (gh > 0), dim=1).to(torch.int32)


def near_pairs(keys, nn, gidx, gh):
    """(ng,) int32: per group its (live slot, staged particle) pairs, the
    work of ``sidm_near``'s kernel and the weights of its work items
    (``work_items.plan_items`` with p_min NEAR_PIECE); the plain version
    of the kernel's ``near_weight`` (``csrc/sidm_near.cu``)."""
    pairs = segment_totals(keys, nn).long() * live_slots(gidx, gh).long()
    return torch.clamp(pairs, max=IMAX).to(torch.int32)


NEAR_PIECE = 1 << 16    # least (live slot, staged particle) pairs of one
                        # work item of sidm_near's kernel


MAX_GROW = 5    # cap doublings of the walk's caps in sized_segments


def sized_segments(tree: Octree, rlev, glo, ghi, pad, seg_cap: int, *,
                   cfg: Optional[FusedConfig] = None, box: float = 0.0,
                   drops: Optional[dict] = None, on_walk=None,
                   use_hmax: bool = False):
    """``range_segments`` with the segment lists and the walk's caps sized
    from the walk's own demand: when ``seg_cap`` was short, once more at
    the demand rounded up to 1024 (JAX walks without a segment cap); a
    walk that dropped cells (``open_cap``, the frontier width ``w_max``,
    ``big_cap`` or ``big_chunks``) is walked again with the caps that
    dropped doubled, up to MAX_GROW times (JAX drops them silently); what
    still drops is left in ``drops``. Returns range_segments' five
    outputs, the segment cap and the FusedConfig used. on_walk: optional
    observer ``on_walk(kw)`` of each ``range_segments`` call's
    arguments. ``use_hmax``: the hydro walk (``range_segments``)."""
    cfg = cfg or FusedConfig()
    drops = {} if drops is None else drops
    grown = 0
    while True:
        kw = dict(tree=tree, rlev=rlev, glo=glo, ghi=ghi, pad=pad,
                  seg_cap=seg_cap, cfg=cfg, box=box, use_hmax=use_hmax)
        if on_walk is not None:
            on_walk(kw)
        keys, nn, ovf, need, stat = range_segments(**kw, drops=drops)
        short, opened, over, big = (int(x) for x in torch.stack([
            torch.sum(stat[S_OVF_N]), drops["open"], drops["big_over"],
            drops["big_drop"]]).tolist())
        if (opened or over or big) and grown < MAX_GROW:
            grown += 1
            cfg = cfg._replace(
                w_max=2 * cfg.w_max if opened else cfg.w_max,
                open_cap=2 * cfg.open_cap if opened else cfg.open_cap,
                big_cap=min(2 * cfg.big_cap, BIG_MAX) if over
                else cfg.big_cap,
                big_chunks=2 * cfg.big_chunks if big else cfg.big_chunks)
        elif short:
            seg_cap = -(-int(need) // 1024) * 1024
        else:
            return keys, nn, ovf, need, stat, seg_cap, cfg
        if short:
            seg_cap = max(seg_cap, -(-int(need) // 1024) * 1024)


def group_targets(tree: Octree, pidx, gvalid, radius_sorted, type_sorted,
                  box: float = 0.0):
    """Per group slot: position, radius (0 on dead slots), type (-9 on dead
    slots) and sorted id (-1 on dead slots); per group the bounding box of
    the slots with a radius and the largest radius. Dead groups are parked
    far outside the tree, or, with a periodic ``box`` (no "far outside"
    under the minimum image), with an inverted huge box that no cell is in
    range of (JAX ``fused_range.py:538-546``)."""
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
    if box:
        glo = torch.where(any_v[:, None], glo, torch.full_like(glo, 1e18))
        ghi = torch.where(any_v[:, None], ghi, torch.full_like(ghi, -1e18))
    else:
        far_here = tree.origin + 4.0 * tree.extent
        glo = torch.where(any_v[:, None], glo, far_here)
        ghi = torch.where(any_v[:, None], ghi, far_here)
    glo, ghi = glo.contiguous(), ghi.contiguous()
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
                         seg_cap: int = 8192, box: float = 0.0):
    """Initial smoothing lengths (setup_smoothinglengths_sidm analog,
    init.c:159): the cell-count seed, then ``iters`` counting passes of
    the controller h *= clip((k/cnt)^(1/3), 0.5, 2) (capped at 8x the
    median), and a last count at the final h; ``box`` > 0: minimum-image
    counts in the periodic box (the tree built on the box). Returns the
    particles with ``hsml_vd`` and ``ngb_vd`` set for the collisionless
    ones."""
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
            tree, pidx, gvalid, h[perm], typs_s, box=box)
        keys, nn, _, _, _, seg_cap, cfg = sized_segments(
            tree, rlev, glo, ghi, pad, seg_cap, cfg=cfg, box=box)
        cnt_sorted = count_neighbours(keys, nn, src, gt, gh, gty, gidx, n,
                                      box=box)
        cnt_flat = cnt_sorted[inv]
        if it < iters:
            ratio = (k / torch.clamp(cnt_flat, min=1).to(dtype)) ** (1.0 / 3.0)
            h = cap(torch.where(col, h * torch.clamp(ratio, 0.5, 2.0), h))
    return dataclasses.replace(
        p, hsml_vd=torch.where(col, h, p.hsml_vd),
        ngb_vd=torch.where(col, cnt_flat, p.ngb_vd).to(torch.int32))


# ------------------------------------------------- DSMC on the range walk


def make_gated_windows(keys_s, hs, n: int, depth: int):
    """Morton windows over the gated targets (hs > 0) only
    (``make_gated_windows`` :432-459): the P_max pre-gate passes a few
    percent of the particles, so the gated ones, compacted in sorted order,
    fill ~G slots per group instead of one or two. Returns (pidx (ng, G)
    sorted particle index per slot, gvalid) with the groups that hold no
    gated target left out (JAX keeps them, parked: they walk nothing and
    scatter nothing)."""
    dev = keys_s.device
    gate = hs > 0
    idx = torch.arange(n, device=dev)
    cpos = torch.cumsum(gate, 0)
    dest = torch.where(gate, cpos - 1, torch.full_like(cpos, n))
    gpos = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    gpos.scatter_(0, dest, idx)
    gpos = gpos[:n]
    slotmask = idx < cpos[-1]
    keys_g = torch.where(slotmask, keys_s[gpos],
                         torch.full_like(keys_s, SENTINEL))
    pidx_g, gvalid = make_windows(keys_g, slotmask, n, depth)
    live = torch.nonzero(torch.any(gvalid, dim=1)).flatten()
    return gpos[pidx_g[live]], gvalid[live].contiguous()


def sidm_near_plain(keys, nn, rows, gt, gv, gh, gdt, gty, gidx, salt: int,
                    time, sigma_co, params: SidmParams, box: float = 0.0,
                    budget: int = 1 << 23):
    """Plain PyTorch version of ``sidm_near``: JAX's ``_sidm_near_tile``
    over each live slot's group segment particles, in batches of live
    slots (the best key's partner the largest sorted id among equal
    keys)."""
    ng = keys.shape[0]
    dev, dtype = rows.device, rows.dtype
    ptot = torch.zeros(ng * G, dtype=dtype, device=dev)
    ncnt = torch.zeros(ng * G, dtype=torch.int32, device=dev)
    bestk = torch.full((ng * G,), float("-inf"), dtype=torch.float32,
                       device=dev)
    bestj = torch.full((ng * G,), -1, dtype=torch.int32, device=dev)
    shape = (ng, G)
    # a slot with no radius or no particle has no pair: only live slots
    slots = torch.nonzero(((gidx >= 0) & (gh > 0)).reshape(-1)).flatten()
    if slots.numel() == 0:
        return (ptot.reshape(shape), ncnt.reshape(shape),
                bestk.reshape(shape), bestj.reshape(shape))
    idx_all, val_all = segment_particles(keys, nn)
    P = max(idx_all.shape[1], 1)
    B = max(1, budget // P)
    salt = int(salt) & 0xFFFFFFFF
    flat = [x.reshape(ng * G, *x.shape[2:]) for x in (gt, gv, gh, gdt, gty,
                                                       gidx)]
    for b0 in range(0, slots.numel(), B):
        sl = slots[b0:b0 + B]
        t, v, th, tdt, ty, ti = (x[sl] for x in flat)
        idx, val = idx_all[sl // G], val_all[sl // G]     # (L, P)
        s = rows[idx]                                   # (L, P, 8)
        d = [min_image(t[:, None, c] - s[..., c], box) for c in range(3)]
        r = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        aux = s[..., 7]
        s_type = torch.remainder(aux, 8.0).to(torch.int32)
        ok = (val & (idx != ti[:, None]) & (r < th[:, None])
              & ~(aux >= 8.0) & (s_type == ty[:, None]))
        h_safe = torch.clamp(th, min=1e-30)[:, None]
        wk = sph_kernel(r / h_safe) / h_safe ** 3
        w = [v[:, None, c] - s[..., 3 + c] for c in range(3)]
        rv = torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
        sgv = sigma_v_product(rv, time, sigma_co, params.cross_section_type,
                              params.yukawa_velocity,
                              params.cross_section_vel_scale,
                              params.cross_section_pow_law, params.comoving)
        prob = torch.where(ok, 0.5 * s[..., 6] * wk * sgv * tdt[:, None],
                           torch.zeros_like(wk))
        key = torch.where(
            prob > 0,
            torch.log(torch.clamp(prob, min=1e-37)).to(torch.float32)
            + pair_gumbel(ti[:, None], idx, salt),
            torch.full_like(wk, float("-inf"), dtype=torch.float32))
        km = torch.max(key, dim=-1).values
        jm = torch.max(torch.where(key == km[:, None], idx,
                                   torch.full_like(idx, -1)), dim=-1).values
        ptot[sl] = torch.sum(prob, dim=-1)
        ncnt[sl] = torch.sum(ok, dim=-1).to(torch.int32)
        bestk[sl] = km
        bestj[sl] = torch.where(torch.isfinite(km), jm,
                                torch.full_like(jm, -1)).to(torch.int32)
    return (ptot.reshape(shape), ncnt.reshape(shape), bestk.reshape(shape),
            bestj.reshape(shape))


def sidm_near(keys, nn, rows, gt, gv, gh, gdt, gty, gidx, salt: int, time,
              sigma_co, params: SidmParams, box: float = 0.0):
    """The DSMC pass over the walked segments (``_sidm_near_tile`` :127 as
    ``_sidm_near_level`` :207 runs it on every level): per group slot, over
    the particles of the group's segments (keys (ng, L) int32
    ``start*32+cnt`` with live counts nn (ng,), as ``range_segments``
    returns them), the pair probabilities P_j = 0.5 m_j W(r/h)/h^3
    sigma(v) v dt over the same-type, non-pending partners other than
    itself with r < h, their sum, the count and the Gumbel-max partner (on
    equal keys the larger sorted id wins). rows (n, 8) sorted [pos3 vel3
    mass aux]; gt, gv (ng, G, 3) slot positions and velocities; gh, gdt
    (ng, G) radius (0: not gated) and dt_h0; gty, gidx (ng, G) int32 type
    and sorted id (-9, -1 on dead slots); box > 0: minimum-image distances.
    Returns (ng, G) (ptot, ncnt, bestk, bestj); a slot with no partner
    keeps (0, 0, -inf, -1). On a CUDA tensor the kernel
    (``csrc/sidm_near.cu``) gives threads to the live slots only and runs
    one block per work item (``csrc/work_items.cuh``: the groups cut by
    their (live slot, staged particle) pairs, ``near_pairs``, into items
    of at least NEAR_PIECE pairs, each an even share of its group's keys),
    whose partials it adds in item order."""
    if not keys.is_cuda:
        return sidm_near_plain(keys, nn, rows, gt, gv, gh, gdt, gty, gidx,
                               salt, time, sigma_co, params, box)
    from .._build import check_cuda, kernels_lib, launch_args
    from .list_range import _gated_consts
    from .work_items import item_buffers
    ng, L = keys.shape
    n = rows.shape[0]
    check_cuda("sidm_near", keys=(keys, torch.int32, (ng, L)),
               nn=(nn, torch.int32, (ng,)),
               rows=(rows, torch.float32, (n, 8)),
               gt=(gt, torch.float32, (ng, G, 3)),
               gv=(gv, torch.float32, (ng, G, 3)),
               gh=(gh, torch.float32, (ng, G)),
               gdt=(gdt, torch.float32, (ng, G)),
               gty=(gty, torch.int32, (ng, G)),
               gidx=(gidx, torch.int32, (ng, G)))
    dev = keys.device
    ptot = torch.empty(ng, G, dtype=torch.float32, device=dev)
    ncnt = torch.empty(ng, G, dtype=torch.int32, device=dev)
    bestk = torch.empty(ng, G, dtype=torch.float32, device=dev)
    bestj = torch.empty(ng, G, dtype=torch.int32, device=dev)
    if ng == 0:
        return ptot, ncnt, bestk, bestj
    sco, vc, vs, pl = _gated_consts(time, sigma_co, params)
    icap, ws, part = item_buffers(ng, dev, near=False)
    w = torch.empty(ng, dtype=torch.int32, device=dev)
    err = kernels_lib().sidm_near_launch(*launch_args(
        keys, nn, ng, L, rows, n, gt, gv, gh, gdt, gty, gidx,
        int(salt) & 0xFFFFFFFF, int(params.cross_section_type), sco, vc, vs,
        pl, float(box), NEAR_PIECE, icap, w, ws, part, ptot, ncnt, bestk,
        bestj))
    if err:
        raise RuntimeError(f"sidm_near kernel launch failed: CUDA error "
                           f"{err}")
    sidm_near.launches += 1
    return ptot, ncnt, bestk, bestj


sidm_near.launches = 0


def sidm_scatter_fused(p, pos_pred, tree: Octree, time, active, vmax, key,
                       params: SidmParams, cfg: Optional[FusedConfig] = None,
                       salt: int = 0, box: float = 0.0,
                       return_info: bool = False, seg_cap: int = 8192,
                       on_walk=None, on_near=None):
    """One step's DSMC on the range walk (``sidm_scatter_fused``
    :462-593): the P_max pre-gate (``tree_sidm_prep``), Morton windows over
    the gated targets, their range walk with pad = the group's largest h
    plus the tree's refresh drift (``range_segments``, lists sized from
    the walk's demand), the pair pass over the walked segments
    (``sidm_near``), then the scatter decision, conflicts, kicks and the
    hsml controller (``tree_sidm_finish``). ``box`` > 0: periodic, the
    tree built on the box. A walk that drops cells is walked again with
    larger caps (``sized_segments``; JAX's walk drops them
    silently): ``cfg`` and ``seg_cap`` are the first guesses, the ones used
    come back in ``info``. Returns (particles with the kicks in ``dvel``,
    n_scattered (a 0-d tensor)), with ``params.log_events`` and no
    ``return_info`` also the step's events (JAX's return), and with
    ``return_info`` a dict: the finish's (kicks, accepted set, proposals,
    resolver rounds and drops; ``events`` with ``params.log_events``),
    the walk's drops (``ovf_walk``: cells past its caps; ``ovf_big``:
    particles past the overfull cells' chunks; ``ovf_seg``: segment list
    drops, 0 after the resize) as 0-d tensors, ``n_gated``, ``ngb_total``,
    ``groups``, ``seg_cap`` and the sorted-order pass outputs. A drop is a
    scattering rate biased low: the caller reads and reports them.
    on_walk: optional observer of the range walk's arguments (see
    ``sized_segments``); on_near: optional observer ``on_near(kw)`` of
    ``sidm_near``'s arguments."""
    n = pos_pred.shape[0]
    rows, hs, dts, typs, sigma_co, scan, h_eff, p_max, u = tree_sidm_prep(
        p, pos_pred, tree.perm, time, active, vmax, key, params)
    pidx, gvalid = make_gated_windows(tree.keys_s, hs, n, tree.depth)
    gt, gh, gty, gidx, glo, ghi, gmax = group_targets(
        tree, pidx, gvalid, hs, typs, box=box)
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    gv = torch.where(gvalid[..., None], rows[pidx][..., 3:6], zero)
    gdt = torch.where(gvalid, dts[pidx], zero)
    pad = (gmax + tree.drift).contiguous()
    zero = torch.zeros((), dtype=torch.long, device=rows.device)
    drops = dict(open=zero, big_over=zero, big_drop=zero)
    cfg = cfg or FusedConfig()
    if pidx.shape[0]:
        keys, nn, _, _, stat, seg_cap, cfg = sized_segments(
            tree, range_levels(tree), glo, ghi, pad, seg_cap, cfg=cfg,
            box=box, drops=drops, on_walk=on_walk)
    else:       # nothing gated (a dt = 0 step): no walk, no pass
        keys = torch.empty(0, 1, dtype=torch.int32, device=rows.device)
        nn = torch.empty(0, dtype=torch.int32, device=rows.device)
        stat = torch.zeros(5, 0, dtype=torch.long, device=rows.device)
    near = dict(keys=keys, nn=nn, rows=rows, gt=gt, gv=gv.contiguous(),
                gh=gh, gdt=gdt.contiguous(), gty=gty, gidx=gidx, salt=salt,
                time=time, sigma_co=sigma_co, params=params, box=box)
    if on_near is not None:
        on_near(near)
    ptot, ncnt, bestk, bestj = sidm_near(**near)

    flat = torch.where(gvalid, pidx, torch.full_like(pidx, n)).reshape(-1)

    def unflat(x, fill):
        buf = torch.full((n + 1,), fill, dtype=x.dtype, device=x.device)
        return buf.scatter_(0, flat, x.reshape(-1))[:n]

    ptot_t, cnt_t = unflat(ptot, 0.0), unflat(ncnt, 0)
    bestk_t, bj_t = unflat(bestk, float("-inf")), unflat(bestj, -1)
    inv = torch.empty_like(tree.perm)
    inv[tree.perm] = torch.arange(n, device=inv.device)
    p2, n_scat, info = tree_sidm_finish(
        p, pos_pred, tree.perm, inv, ptot_t, cnt_t, bj_t, time, active,
        scan, p_max, u, key, params)
    if not return_info:
        return (p2, n_scat, info["events"]) if params.log_events \
            else (p2, n_scat)
    info.update(ovf_walk=torch.sum(stat[S_OVF_L].long()),
                ovf_big=drops["big_drop"],
                ovf_seg=torch.sum(stat[S_OVF_N].long()),
                n_gated=torch.sum(hs > 0), ngb_total=torch.sum(ncnt.long()),
                groups=pidx.shape[0], seg_cap=seg_cap, cfg=cfg, rows=rows,
                hs=hs,
                dts=dts, ptot=ptot_t, cnt=cnt_t, bestk=bestk_t, bestj=bj_t,
                sigma_co=sigma_co)
    return p2, n_scat, info
