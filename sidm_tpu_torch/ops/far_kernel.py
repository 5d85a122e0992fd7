"""One walk level's classification, written out compacted: the port of
``sidm_tpu/ops/pallas_far.py:_far_kernel`` (driven by ``far_items``, :194).

``far_level`` classifies one level's frontier for every target group
(geometric or relative MAC against the group box, the BMAX guard,
leaf_cap, the last level's "big" path) and hands each group's results to
its caller already compacted, in frontier order (``Level``):

* walk mode: the accepted (far) node ids, level-local; the segment keys
  ``nstart*32+min(cnt,31)`` of opened leaves; the next frontier (the
  first ``O = min(W, open_cap)`` opened inner cells expanded into their
  ``ccnt`` contiguous children, truncated at ``Wn``); on the last level
  the first ``big_cap`` overfull cells cut into 16-particle chunk keys
  (``big_chunks`` per cell); and the per-group counts (``cnt``, rows
  ``C_*``). The far field of the accepted nodes is the caller's:
  ``wq_force._wq_eval`` hands the compacted ids to ``far_list``;
* record mode (``lists`` given, the cached-list engine's recording walk,
  ``sidm_tpu/ops/list_force.py:_walk_level_keys`` :160-217 and
  ``_record`` :220-366): the far flat ids ``lvl_base + id`` and the
  segment keys (and, on the last level, the chunk keys) are appended to the
  group's lists in place, under the level cap ``lvl_cap`` and the list
  caps, and the list counts and the telemetry (uncapped demand, drops) are
  updated in place; the next frontier and the counts are returned.

Periodic walk mode (``pbc`` = (box, alpha, rcut), the TreePM split's
short range; ``_classify``'s pbc branch, sidm_tpu/ops/fused_force.py
:426-486, which JAX's periodic walk runs in XLA instead of its Pallas
kernel): the bbox-to-COM distance is taken by the minimum image about the
group box's centre, and a cell whose bounding sphere cannot reach within
``rcut`` of the group (sqrt(r2b) > rcut + bmax) is dropped, neither opened
nor accepted (its force is all on the mesh). Dead groups are parked with an
inverted huge box, so nothing reaches them. The record mode takes no box
(``ListMode 1`` with a periodic box is not ported).

``far_level_plain`` also runs the range test (``range_walk``, record mode
on the range rows of ``ops/fused_range.range_levels``, the SIDM candidate
record's walk, ``sidm_tpu/ops/list_range.py:_record_segments`` :94-202):
the range test of ``sidm_tpu/ops/fused_range.py:_range_classify`` :99
replaces the MAC (a cell is in range when its box, geometric centre +-
s_l/2, lies within the group's pad of the group box: d^2 <= pad^2; ``oac``
holds the pad), cells out of range are dropped, and only segment and chunk
keys are appended (to ``lists.near``); frontier order, ``open_cap``, the
level and list caps and the big-cell chunks are the record mode's, and so
is the telemetry, except that particles past ``big_chunks`` chunks of an
overfull cell are not counted as drops (the JAX range walk does not count
them). With a periodic ``box`` the distance is taken from the group box's
centre by the minimum image, ``d - box*round(d/box)``
(``_range_classify``'s periodic branch; dead groups are parked with an
inverted huge box, so no cell is in range of them). That level is a step of
``fused_range.range_walk_plain``, the plain version of the whole range
walk; on the card the walk is one launch of its own kernel
(``csrc/range_walk.cu``, ``fused_range.range_segments``), not a
``far_level`` per level.

Only a row's live prefix is written: entries past a count hold whatever
the buffer held (``torch.empty``) and no consumer reads them.

On a CUDA tensor it launches ``csrc/far_kernel.cu``; on a CPU tensor it
runs ``far_level_plain``: the dense key
planes of the TPU kernel (``level_planes``) compacted and appended by the
JAX package's steps (``compact_plane``, ``_expand_open``, ``_append``,
``_big_keys``). There is no fallback between the two. The outputs are
bit-equal.

Kernel design (``csrc/far_kernel.cu``). The TPU kernel runs one grid step
per (group, 128-node chunk) item and writes dense (group, slot) key planes
that XLA compacts afterwards; at N = 1e6 those planes are 0.5 GB each per
level, almost all of it the sentinel. On Hopper one thread block owns a
group and walks its frontier in order, so it writes each stream already
compacted: warp ballots and a warp scan of the child counts place every
output, the running offsets are the same in every thread, and one
``__syncthreads`` per chunk (double-buffered warp totals) orders it.
Each node row is read as two 16-byte loads and bmax^2 (the quadrupole is
not needed to classify). Classification rounds each product and sum
explicitly (and the file builds with ``-fmad=false``), so the decisions
equal the plain version's bit for bit. What bounds it on the H100: bytes
(the live frontier's ids and node rows read, the compacted outputs
written).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .fused_force import (IMAX, R_CCNT, R_CNT, R_CSTART, R_NSTART, WC,
                          classify, compact_plane, range_classify)

ITEM_BLOCK = 512   # plain version: (group, chunk) items per batch
BIG_MAX = 64       # largest big_cap (csrc/far_kernel.cu kBigMax)

# rows of Level.cnt (csrc/far_kernel.cu kFar ... kBigDrop), per group:
C_FAR = 0          # accepted nodes
C_SEG = 1          # segment keys (opened leaves)
C_NEXT = 2         # next frontier width, min(children of the first O, Wn)
C_OPEN = 3         # opened inner cells (uncapped)
C_OVF_OPEN = 4     # opened cells past O + children past Wn
C_BIG = 5          # overfull deepest cells (uncapped)
C_BK = 6           # chunk keys of the first big_cap of them
C_BIG_DROP = 7     # particles past big_chunks chunks in those cells
N_CNT = 8

# rows of ListBuf.stat (csrc/far_kernel.cu kNeedF ... kOvfN), per group:
S_NEED_F, S_NEED_N, S_OVF_L, S_OVF_F, S_OVF_N = range(5)


class Level(NamedTuple):
    far: Optional[torch.Tensor]   # (ng, W) level-local ids, prefix C_FAR
    seg: Optional[torch.Tensor]   # (ng, W) segment keys, prefix C_SEG
    fids: Optional[torch.Tensor]  # (ng, Wn) next frontier, prefix C_NEXT
    bkey: Optional[torch.Tensor]  # (ng, big_cap*big_chunks) chunk keys,
                                  # prefix C_BK (walk mode, last level)
    cnt: torch.Tensor             # (N_CNT, ng) int32 counts


class ListBuf(NamedTuple):
    """The recording walk's per-group lists, updated in place level by
    level: far (ng, LF) flat node ids and near (ng, LN) segment keys with
    live prefixes nf, nn; stat (5, ng) int32 the telemetry (rows S_*)."""
    far: torch.Tensor
    near: torch.Tensor
    nf: torch.Tensor
    nn: torch.Tensor
    stat: torch.Tensor


def list_buf(ng: int, LF: int, LN: int, device) -> ListBuf:
    """Empty lists. The near list's tail is IMAX (it is the lists' output
    as it stands); the far list's tail is never read."""
    i32 = dict(dtype=torch.int32, device=device)
    return ListBuf(far=torch.empty(ng, LF, **i32),
                   near=torch.full((ng, LN), IMAX, **i32),
                   nf=torch.zeros(ng, **i32), nn=torch.zeros(ng, **i32),
                   stat=torch.zeros(5, ng, **i32))


def level_planes(fids, n_live, tbl, nl_real: int, s_l, glo, ghi, oac, *,
                 theta2: float, use_relative: bool, leaf_cap: int,
                 last: bool, range_walk: bool = False, box: float = 0.0,
                 pbc=None):
    """The TPU kernel's classification in plain PyTorch: the dense
    (ng, W) int32 planes of far (level-local id), segment, open
    (``cstart*16+ccnt``) and big (id) keys, IMAX elsewhere. Live (group,
    chunk) items run in batches of ITEM_BLOCK. ``range_walk``: the range
    test on range rows, oac the pad (no far keys), minimum-image with a
    periodic ``box`` > 0; ``pbc``: the walk's periodic classification."""
    ng, W = fids.shape
    wc = min(WC, W)
    maxc = W // wc
    dev = tbl.device
    keys = torch.full((4, ng, maxc, wc), IMAX, dtype=torch.int32, device=dev)
    nl = torch.clamp(n_live.long(), max=W)
    nc = -(-nl // wc)
    gi, ci = torch.nonzero(torch.arange(maxc, device=dev)[None, :]
                           < nc[:, None], as_tuple=True)
    fids_c = fids.reshape(ng, maxc, wc)
    col = torch.arange(wc, device=dev)
    for b0 in range(0, gi.shape[0], ITEM_BLOCK):
        g = gi[b0:b0 + ITEM_BLOCK]
        c = ci[b0:b0 + ITEM_BLOCK]
        ids = torch.where(c[:, None] * wc + col < nl[g, None],
                          fids_c[g, c].long(), -1)
        dead = (ids < 0) | (ids >= nl_real)
        rows = tbl[torch.clamp(ids, 0, tbl.shape[0] - 1)]
        rows = torch.where(dead[..., None], torch.zeros_like(rows), rows)
        if range_walk:
            far, seg, opn, big = range_classify(rows, glo[g], ghi[g], oac[g],
                                                s_l, leaf_cap, last, box)
        else:
            far, seg, opn, big = classify(rows, glo[g], ghi[g], oac[g], s_l,
                                          theta2, use_relative, leaf_cap,
                                          last, pbc)
        ri = rows.to(torch.int32)
        imax = torch.full_like(ri[..., 0], IMAX)
        keys[0, g, c] = torch.where(far, ids.to(torch.int32), imax)
        keys[1, g, c] = torch.where(
            seg, ri[..., R_NSTART] * 32 + torch.clamp(ri[..., R_CNT], max=31),
            imax)
        keys[2, g, c] = torch.where(
            opn, ri[..., R_CSTART] * 16 + ri[..., R_CCNT], imax)
        keys[3, g, c] = torch.where(big, ids.to(torch.int32), imax)
    return keys.reshape(4, ng, W).unbind(0)


def _expand_open(openk, *, Wn: int, O: int):
    """Open keys -> next frontier (fids (ng, Wn), -1 past the live count),
    its width, and per group the opened cells and the dropped count
    (cells past O, children past Wn) (``_expand_open_wq``,
    sidm_tpu/ops/wq_force.py:357)."""
    ng, W = openk.shape
    open_sorted, n_open = compact_plane(openk)
    open_sorted = open_sorted[:, :O]
    ovf = torch.clamp(n_open - O, min=0)
    oval = open_sorted != IMAX
    zero = torch.zeros_like(open_sorted)
    cs = torch.where(oval, open_sorted >> 4, zero)
    cc = torch.where(oval, open_sorted & 15, zero)
    k = torch.arange(8, dtype=torch.int32, device=openk.device)
    kids = torch.where(k < cc[:, :, None], cs[:, :, None] + k,
                       torch.full_like(cs[:, :, None], IMAX))
    kids = kids.reshape(ng, 8 * O)
    kids, n_child = compact_plane(kids)
    if 8 * O > Wn:
        kids = kids[:, :Wn]
        ovf = ovf + torch.clamp(n_child - Wn, min=0)
    else:
        kids = torch.cat([kids, torch.full((ng, Wn - 8 * O), IMAX,
                                           dtype=kids.dtype,
                                           device=kids.device)], dim=1)
    fids = torch.where(kids == IMAX, torch.full_like(kids, -1), kids)
    return (fids.contiguous(), torch.clamp(n_child, max=Wn).to(torch.int32),
            n_open, ovf.to(torch.int32))


def _big_keys(bigk, tbl, *, big_cap: int, big_chunks: int):
    """The first big_cap overfull cells -> their 16-particle chunk keys
    ``start*32+cnt``, compacted (``_wq_eval`` :520-540, ``_record``
    :339-366). Returns (keys (ng, big_cap*big_chunks), per group: chunk
    keys, overfull cells, particles past big_chunks chunks)."""
    ng = bigk.shape[0]
    bid, n_big = compact_plane(bigk)
    bid = bid[:, :big_cap]
    bval = bid != IMAX
    brow = tbl[torch.clamp(bid.long(), 0, tbl.shape[0] - 1)]
    bstart = brow[..., R_NSTART].to(torch.int32)
    bcnt = torch.where(bval, brow[..., R_CNT].to(torch.int32),
                       torch.zeros_like(bstart))
    k16 = torch.arange(big_chunks, dtype=torch.int32,
                       device=bigk.device) * 16
    cst = bstart[:, :, None] + k16
    ccn = torch.clamp(bcnt[:, :, None] - k16, 0, 16)
    bkey = torch.where(ccn > 0, cst * 32 + ccn, torch.full_like(cst, IMAX))
    bkey, n_bk = compact_plane(bkey.reshape(ng, big_cap * big_chunks))
    drop = torch.sum(torch.clamp(bcnt - 16 * big_chunks, min=0), dim=1)
    return bkey, n_bk, n_big, drop.to(torch.int32)


def _append(dst, n_dst, plane, take):
    """Append each row's first ``take`` entries of ``plane`` to ``dst`` at
    column ``n_dst`` (one scatter; entries past the width are dropped).
    Returns (dst, new counts, dropped count per row)."""
    ng, W = plane.shape
    LD = dst.shape[1]
    col = torch.arange(W, device=plane.device)
    pos = n_dst[:, None].long() + col
    ok = (col < take[:, None]) & (pos < LD)
    out = torch.cat([dst, torch.full((ng, 1), IMAX, dtype=dst.dtype,
                                     device=dst.device)], dim=1)
    out.scatter_(1, torch.where(ok, pos, torch.full_like(pos, LD)),
                 torch.where(ok, plane, torch.full_like(plane, IMAX)))
    n_new = torch.clamp(n_dst + take, max=LD)
    return out[:, :LD], n_new.to(torch.int32), n_dst + take - n_new


def far_level_plain(fids, n_live, tbl, nl_real: int, s_l, glo, ghi, oac, *,
                    theta2: float, use_relative: bool, leaf_cap: int,
                    last: bool, Wn: int,
                    open_cap: int, big_cap: int, big_chunks: int,
                    lists: Optional[ListBuf] = None, lvl_base: int = 0,
                    lvl_cap: Optional[int] = None,
                    range_walk: bool = False, box: float = 0.0,
                    pbc=None) -> Level:
    """Plain PyTorch version of ``far_level``: ``level_planes`` compacted
    and appended step by step, as the JAX package does."""
    ng, W = fids.shape
    dev = fids.device
    fark, segk, openk, bigk = level_planes(
        fids, n_live, tbl, nl_real, s_l, glo, ghi, oac, theta2=theta2,
        use_relative=use_relative, leaf_cap=leaf_cap, last=last,
        range_walk=range_walk, box=box, pbc=pbc)
    zeros = torch.zeros(ng, dtype=torch.int32, device=dev)
    far, n_far = compact_plane(fark)
    seg, n_seg = compact_plane(segk)
    fids_n, n_next, n_open, ovf_open = None, zeros, zeros, zeros
    if not last:
        fids_n, n_next, n_open, ovf_open = _expand_open(
            openk, Wn=Wn, O=min(W, open_cap))
    bkey, n_bk, n_big, big_drop = None, zeros, zeros, zeros
    if last:
        bkey, n_bk, n_big, big_drop = _big_keys(
            bigk, tbl, big_cap=big_cap, big_chunks=big_chunks)
    cnt = torch.stack([n_far, n_seg, n_next, n_open, ovf_open, n_big, n_bk,
                       big_drop]).to(torch.int32)
    if lists is None:
        return Level(far=far, seg=seg, fids=fids_n, bkey=bkey, cnt=cnt)

    # record: the level's lists appended under the level and list caps
    LC = W if lvl_cap is None else min(lvl_cap, W)
    far = torch.where(far != IMAX, far + lvl_base, far)
    st = lists.stat
    st[S_NEED_F] += n_far
    st[S_NEED_N] += n_seg
    st[S_OVF_L] += (torch.clamp(n_far - LC, min=0)
                    + torch.clamp(n_seg - LC, min=0) + ovf_open).to(
                        torch.int32)
    lf, nf, d = _append(lists.far, lists.nf, far[:, :LC],
                        torch.clamp(n_far, max=LC))
    st[S_OVF_F] += d.to(torch.int32)
    ln, nn, d = _append(lists.near, lists.nn, seg[:, :LC],
                        torch.clamp(n_seg, max=LC))
    st[S_OVF_N] += d.to(torch.int32)
    if last:
        over = torch.clamp(n_big - big_cap, min=0)
        st[S_NEED_N] += (n_bk + over * big_chunks).to(torch.int32)
        ln, nn, d = _append(ln, nn, bkey, n_bk)
        st[S_OVF_N] += d.to(torch.int32)
        st[S_OVF_L] += (over if range_walk else over + big_drop).to(
            torch.int32)
    lists.far.copy_(lf)
    lists.near.copy_(ln)
    lists.nf.copy_(nf)
    lists.nn.copy_(nn)
    return Level(far=None, seg=None, fids=fids_n, bkey=None, cnt=cnt)


def far_level(fids, n_live, tbl, nl_real: int, s_l, glo, ghi, oac, *,
              theta2: float, use_relative: bool, leaf_cap: int, last: bool,
              Wn: int, open_cap: int,
              big_cap: int, big_chunks: int,
              lists: Optional[ListBuf] = None, lvl_base: int = 0,
              lvl_cap: Optional[int] = None, pbc=None) -> Level:
    """One level of the walk for every group.

    fids (ng, W) int32 level-local node ids, live prefix n_live (ng,)
    int32; tbl (cap, 16) float32 level node rows (``pack_tree``); nl_real:
    real node count of the level; s_l () float32 cell size (+ 2 drift);
    glo/ghi (ng, 3) group bounding boxes; oac (ng,) relative-criterion
    thresholds; Wn: the next level's frontier width (unused on the last
    level); open_cap, big_cap (<= BIG_MAX), big_chunks: the walk's caps.

    With ``lists`` (record mode) lvl_base is the level's flat node offset
    and lvl_cap the level cap (None: none); the lists are updated in
    place. ``pbc`` (box, alpha, rcut): the periodic walk mode (walk mode
    only).

    Returns a ``Level``."""
    if pbc is not None and lists is not None:
        raise NotImplementedError(
            "far_level: the record mode with a periodic box (ListMode 1 with "
            "PeriodicBoundariesOn) is not ported to sidm_tpu_torch yet "
            "(ROADMAP.md A, item 11)")
    if not fids.is_cuda:
        return far_level_plain(
            fids, n_live, tbl, nl_real, s_l, glo, ghi, oac, theta2=theta2,
            use_relative=use_relative, leaf_cap=leaf_cap, last=last, Wn=Wn,
            open_cap=open_cap,
            big_cap=big_cap, big_chunks=big_chunks, lists=lists,
            lvl_base=lvl_base, lvl_cap=lvl_cap, pbc=pbc)
    from .._build import check_cuda, kernels_lib, launch_args

    ng, W = fids.shape
    walk = lists is None
    if big_cap > BIG_MAX:
        raise ValueError(f"far_level: big_cap {big_cap} > {BIG_MAX}")
    specs = dict(fids=(fids, torch.int32, (ng, W)),
                 n_live=(n_live, torch.int32, (ng,)),
                 tbl=(tbl, torch.float32, (tbl.shape[0], 16)),
                 s_l=(s_l, torch.float32, ()),
                 glo=(glo, torch.float32, (ng, 3)),
                 ghi=(ghi, torch.float32, (ng, 3)),
                 oac=(oac, torch.float32, (ng,)))
    if not walk:
        LF, LN = lists.far.shape[1], lists.near.shape[1]
        specs.update(far=(lists.far, torch.int32, (ng, LF)),
                     near=(lists.near, torch.int32, (ng, LN)),
                     nf=(lists.nf, torch.int32, (ng,)),
                     nn=(lists.nn, torch.int32, (ng,)),
                     stat=(lists.stat, torch.int32, (5, ng)))
    check_cuda("far_level", **specs)
    i32 = dict(dtype=torch.int32, device=fids.device)
    nbk = big_cap * big_chunks
    fids_n = None if last else torch.empty(ng, Wn, **i32)
    cnt = torch.empty(N_CNT, ng, **i32)
    if walk:
        far, seg = torch.empty(ng, W, **i32), torch.empty(ng, W, **i32)
        bkey = torch.empty(ng, nbk, **i32) if last else None
        dst = (far, W, seg, W, bkey, None, None, None)
        LC = W
    else:
        LC = W if lvl_cap is None else min(lvl_cap, W)
        dst = (lists.far, LF, lists.near, LN, None, lists.nf, lists.nn,
               lists.stat)
    err = kernels_lib().far_level_launch(*launch_args(
        tbl, int(nl_real), fids, n_live, ng, W, s_l, glo, ghi, oac,
        float(theta2), int(bool(use_relative)), float(leaf_cap), int(last),
        min(W, int(open_cap)), int(Wn) if not last else 0, int(big_cap),
        int(big_chunks), int(lvl_base), LC, *dst[:4], fids_n, dst[4], cnt,
        *dst[5:], float(pbc[0]) if pbc else 0.0,
        float(pbc[2]) if pbc else 0.0, int(pbc is not None)))
    if err:
        raise RuntimeError(f"far_level kernel launch failed: CUDA error "
                           f"{err}")
    if not walk:
        far_level.record_launches += 1
        return Level(far=None, seg=None, fids=fids_n, bkey=None, cnt=cnt)
    if pbc is not None:
        far_level.periodic_launches += 1
    else:
        far_level.launches += 1
    return Level(far=far, seg=seg, fids=fids_n, bkey=bkey, cnt=cnt)


far_level.launches = 0          # launches of the walk mode
far_level.periodic_launches = 0  # ... of its periodic mode (pbc)
far_level.record_launches = 0   # launches of the record mode
far_level.range_launches = 0    # launches of the whole range walk
                                # (fused_range.range_segments, one a walk)
