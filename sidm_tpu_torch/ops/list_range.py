"""Cached per-particle SIDM candidate lists, the DSMC pass of the list
cadence (port of ``sidm_tpu/ops/list_range.py``: ``RangeListConfig`` :52,
``SidmCandidates`` :82, ``_record_segments`` :94, ``_emit_candidates``
:205, ``record_candidates`` :333, ``_eval_gated`` :396,
``candidates_valid`` :519, ``sidm_scatter_lists`` :529, ``h_eff_all``
:580, ``record_candidates_from_particles`` :593).

Once per tree rebuild every collisionless particle gets a candidate list:
the particles within R_i = pad_fac h_i + skin, found by the range walk
(``fused_range.range_segments``: ``csrc/range_walk.cu``) and the
candidate emission (``sidm_emit``): per group, each target tested against
the particles of its group's segments (same type, not itself, r^2 < R_i^2)
and the hits appended in the group's segment order, then particle order,
up to K (the order decides which K a truncated list keeps; ``needk`` keeps
the uncapped demand). Every step the DSMC pass touches only the gated
targets (``sidm_gated``): per target over its live candidates the pair
probabilities P_j = 0.5 m_j W(r/h)/h^3 sigma(v) v dt, their sum P_tot, the
neighbour count and the Gumbel-max partner (on equal keys the larger
sorted id wins). The targets are taken in two tiers as JAX takes them
(those with ncand <= k_dense, then the long lists), each up to its
capacity in index order; targets past a capacity are dropped and counted
(``ovf2``), so Simulation's growth logic is JAX's. Here a tier only decides
which capacity a target counts against: the kernel loops over each
target's own live candidates, with no K padding.

Each kernel has a plain PyTorch version beside it (``*_plain``); the
wrapper runs the plain version for CPU tensors and the kernel
(``csrc/range_walk.cu``, ``csrc/sidm_emit.cu``, ``csrc/sidm_gated.cu``)
for CUDA tensors, and counts its launches.

With a periodic ``box`` > 0 every distance here (the range walk's, the
emission's and the gated tile's) is the minimum image ``d - box*round(d/
box)``, as in the JAX functions' ``box`` branches; dead groups are parked
with an inverted huge box.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import sph_kernel
from ..sidm_common import sigma_v_product
from .fused_force import G, IMAX, FusedConfig, make_windows, min_image
from .fused_range import (group_order, group_targets, range_levels,
                          range_segments, segment_particles)
from .sidm import SidmParams
from .sidm_tree import (h_eff_of, pair_gumbel, sidm_rows, tree_sidm_finish,
                        tree_sidm_prep)
from .tree import Octree


class RangeListConfig(NamedTuple):
    k_cap: int = 384          # candidates per particle (the
                              # ceiling, Simulation.SIDM_K_CEILING)
    seg_cap: int = 8192       # range segments per group
    lvl_cap: int = 4096       # per-level recording width
    pad_fac: float = 1.2      # radius pad factor over h(record)
    gated_frac: float = 0.3   # gated-target capacity, fraction of n
    k_dense: int = 96         # tier split: ncand <= k_dense in the dense
                              # tier, the rest in the tail tier
    tail_frac: float = 0.25   # tail capacity as a fraction of the gated
                              # capacity (when tail_cap = 0)
    tail_cap: int = 0         # absolute tail capacity (Simulation fits it)


class SidmCandidates(NamedTuple):
    cand: torch.Tensor     # (n, K) int32 sorted-order candidate ids, IMAX pad
    ncand: torch.Tensor    # (n,) int32
    r_ref: torch.Tensor    # (n,) record search radius R_i (sorted order)
    pos_ref: torch.Tensor  # (n, 3) sorted positions at record
    ovf: torch.Tensor      # (2,) int64 [segment drops, K drops]
    skin: torch.Tensor     # ()
    need: torch.Tensor     # (2,) int64 [max segments/group, max
                           # candidates/particle], uncapped demand


def sidm_sources(pos_sorted, aux_sorted):
    """(n, 4) float32 [x, y, z, aux] of the sorted particles, aux = type +
    8 pending: what the emission reads of a source."""
    return torch.cat([pos_sorted, aux_sorted[:, None]], dim=1).contiguous()


def _pair_tiles(keys, nn, src, gt, gty, gidx, box: float = 0.0,
                budget=1 << 24):
    """Yield (group slice, source ids, ok mask without the radius test,
    r^2) for batches of groups, in the JAX order of operations."""
    ng = keys.shape[0]
    live = torch.arange(keys.shape[1], device=keys.device)[None, :] \
        < nn[:, None].long()
    per = max(int(torch.sum(torch.where(live, keys & 31, 0), dim=1).max())
              if ng else 1, 1) * G
    B = max(1, budget // per)
    b0 = 0
    while b0 < ng:
        sl = slice(b0, b0 + B)
        idx, val = segment_particles(keys[sl], nn[sl])
        s = src[idx]                                   # (B, P, 4)
        t = gt[sl]
        d = [min_image(t[:, :, None, c] - s[:, None, :, c], box)
             for c in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]   # (B, G, P)
        aux = s[..., 3]
        s_type = torch.remainder(aux, 8.0).to(torch.int32)
        ok = (val[:, None, :] & (idx[:, None, :] != gidx[sl, :, None])
              & (s_type[:, None, :] == gty[sl, :, None]))
        yield sl, idx, ok, r2, aux
        b0 += B


def sidm_emit_plain(keys, nn, src, gt, gr, gty, gidx, n: int, K: int,
                    count_mode: bool = False, box: float = 0.0):
    """Plain PyTorch version of ``sidm_emit``."""
    dev = keys.device
    ncand = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    needk = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    cand = None if count_mode else torch.full((n + 1, K), IMAX,
                                              dtype=torch.int32, device=dev)
    for sl, idx, ok, r2, aux in _pair_tiles(keys, nn, src, gt, gty, gidx,
                                            box):
        rows = torch.where(gidx[sl] >= 0, gidx[sl],
                           torch.full_like(gidx[sl], n)).long()
        r = gr[sl][:, :, None]
        if count_mode:
            hit = ok & (torch.sqrt(r2) < r) & (aux < 8.0)[:, None, :]
            ncand[rows.reshape(-1)] = torch.sum(hit, dim=-1).reshape(-1).to(
                torch.int32)
            continue
        hit = ok & (r2 < r * r)
        rank = torch.cumsum(hit, dim=-1) - 1
        keep = hit & (rank < K)
        need = torch.sum(hit, dim=-1)
        needk[rows.reshape(-1)] = need.reshape(-1).to(torch.int32)
        ncand[rows.reshape(-1)] = torch.clamp(need, max=K).reshape(-1).to(
            torch.int32)
        bi, ti, pi = torch.nonzero(keep, as_tuple=True)
        cand[rows[bi, ti], rank[bi, ti, pi]] = idx[bi, pi].to(torch.int32)
    if count_mode:
        return ncand[:n]
    return cand[:n], ncand[:n], needk[:n]


def sidm_emit(keys, nn, src, gt, gr, gty, gidx, n: int, K: int = 0,
              count_mode: bool = False, box: float = 0.0):
    """Candidate emission for every group's targets (``_emit_candidates``
    :205-317). keys (ng, LR) int32 segment keys with live counts nn (ng,);
    src (n, 4) ``sidm_sources``; gt (ng, G, 3) targets, gr (ng, G) radii
    (0 on dead slots), gty (ng, G) int32 types, gidx (ng, G) int32 sorted
    ids (-1 on dead slots). Returns (cand (n, K) int32 with IMAX past
    ncand, ncand (n,), needk (n,) uncapped demand), rows of particles in
    no valid slot empty; in ``count_mode`` (the hsml init's count,
    ``fused_range.py:179-183``) the (n,) count of non-pending sources with
    sqrt(r^2) < gr instead. ``box`` > 0: minimum-image distances. On a
    CUDA tensor the kernel (``csrc/sidm_emit.cu``) takes the groups in
    ``group_order``."""
    if not keys.is_cuda:
        return sidm_emit_plain(keys, nn, src, gt, gr, gty, gidx, n, K,
                               count_mode, box)
    from .._build import check_cuda, kernels_lib, launch_args
    ng, LR = keys.shape
    check_cuda("sidm_emit", keys=(keys, torch.int32, (ng, LR)),
               nn=(nn, torch.int32, (ng,)),
               src=(src, torch.float32, (n, 4)),
               gt=(gt, torch.float32, (ng, G, 3)),
               gr=(gr, torch.float32, (ng, G)),
               gty=(gty, torch.int32, (ng, G)),
               gidx=(gidx, torch.int32, (ng, G)))
    i32 = dict(dtype=torch.int32, device=keys.device)
    ncand = torch.zeros(n, **i32)
    if count_mode:
        cand, needk, K = None, None, 0
    else:
        cand = torch.full((n, K), IMAX, **i32)
        needk = torch.zeros(n, **i32)
    order = group_order(keys, nn)
    err = kernels_lib().sidm_emit_launch(*launch_args(
        order, keys, nn, ng, LR, src, n, gt, gr, gty, gidx, int(K),
        int(count_mode), float(box), cand, ncand, needk))
    if err:
        raise RuntimeError(f"sidm_emit kernel launch failed: CUDA error "
                           f"{err}")
    if count_mode:
        sidm_emit.count_launches += 1
        return ncand
    sidm_emit.launches += 1
    return cand, ncand, needk


sidm_emit.launches = 0        # emission launches
sidm_emit.count_launches = 0  # count-mode launches


def count_neighbours(keys, nn, src, gt, gh, gty, gidx, n: int,
                     box: float = 0.0):
    """(n,) int32 neighbour counts of the targets (sorted order): the count
    mode of ``sidm_emit``."""
    return sidm_emit(keys, nn, src, gt, gh, gty, gidx, n, count_mode=True,
                     box=box)


def record_candidates(tree: Octree, rows_sorted, h_all_sorted, type_sorted,
                      valid_sorted, *, skin=0.0,
                      cfg: Optional[FusedConfig] = None,
                      rcfg: Optional[RangeListConfig] = None,
                      box: float = 0.0, on_walk=None,
                      on_emit=None) -> SidmCandidates:
    """Candidate lists for all valid collisionless particles of ``tree``.

    rows_sorted (n, 8) [pos3, vel3, mass, aux] in sorted order;
    h_all_sorted the per-particle h_eff in sorted order (ungated too);
    type_sorted the type (or -9 for non-collisionless); box > 0: the
    periodic box (minimum-image distances). on_walk, on_emit: optional
    observers ``on_walk(kw)``, ``on_emit(kw)`` of the range walk's
    (``range_segments``) and the emission's arguments."""
    rcfg = rcfg or RangeListConfig()
    n = tree.pos_s.shape[0]
    dtype, dev = tree.pos_s.dtype, tree.pos_s.device
    pidx, gvalid = make_windows(tree.keys_s, valid_sorted, n, tree.depth)
    skin = torch.as_tensor(skin, dtype=dtype, device=dev)
    r_all = torch.where(valid_sorted & (type_sorted >= 0),
                        rcfg.pad_fac * h_all_sorted + skin,
                        torch.zeros_like(h_all_sorted))
    gt, gr, gty, gidx, glo, ghi, gmax = group_targets(
        tree, pidx, gvalid, r_all, type_sorted, box=box)
    pad = (gmax + tree.drift).contiguous()
    walk = dict(tree=tree, rlev=range_levels(tree), glo=glo, ghi=ghi,
                pad=pad, seg_cap=rcfg.seg_cap, lvl_cap=rcfg.lvl_cap, cfg=cfg,
                box=box)
    if on_walk is not None:
        on_walk(walk)
    keys, nn, ovf_seg, need_seg, _ = range_segments(**walk)
    src = sidm_sources(rows_sorted[:, 0:3], rows_sorted[:, 7])
    K = rcfg.k_cap
    if on_emit is not None:
        on_emit(dict(keys=keys, nn=nn, src=src, gt=gt, gr=gr, gty=gty,
                     gidx=gidx, n=n, K=K, box=box))
    cand, ncand, needk = sidm_emit(keys, nn, src, gt, gr, gty, gidx, n, K,
                                   box=box)
    ovf_k = torch.sum(torch.clamp(needk.long() - K, min=0))
    return SidmCandidates(
        cand=cand, ncand=ncand, r_ref=r_all, pos_ref=tree.pos_s,
        ovf=torch.stack([ovf_seg, ovf_k]), skin=skin,
        need=torch.stack([need_seg, torch.max(needk).long()]))


def gated_targets(hs, ncand, K: int, ngc: int, ntail: int, kd: int):
    """The targets the gated tile evaluates, in JAX's compaction order:
    (tid (ngc + ntail,) int32 sorted ids, -1 on unused slots, ovf2 (2,)
    int64 [gated-capacity drops, tail-capacity drops]). Two tiers when 0 <
    kd < K and ntail > 0: ncand <= kd up to ngc, the rest up to ntail."""
    gate = hs > 0
    n = hs.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=hs.device)

    def first(mask, cap):
        cpos = torch.cumsum(mask, 0)
        dest = torch.where(mask & (cpos <= cap), cpos - 1,
                           torch.full_like(cpos, cap))
        tid = torch.full((cap + 1,), -1, dtype=torch.int32, device=hs.device)
        tid.scatter_(0, dest, ids)
        return tid[:cap], torch.clamp(cpos[-1] - cap, min=0)

    if 0 < kd < K and ntail > 0:
        tail = gate & (ncand > kd)
        tid_a, drop_a = first(gate & ~tail, ngc)
        tid_b, drop_b = first(tail, ntail)
        return torch.cat([tid_a, tid_b]), torch.stack([drop_a, drop_b])
    tid, drop = first(gate, ngc)
    return (torch.cat([tid, torch.full((ntail,), -1, dtype=torch.int32,
                                       device=hs.device)]),
            torch.stack([drop, torch.zeros_like(drop)]))


def _gated_consts(time, sigma_co, params: SidmParams):
    """Scalars of sigma(v) v: (sigma_co, vc, vel_scale, pow_law) floats;
    read from the device only in comoving runs (physical runs: the
    parameters themselves, as ``cross_section_co`` and ``_vc`` give
    them)."""
    sco, vc = params.cross_section_internal, params.yukawa_velocity
    if params.comoving:
        sco = float(sigma_co)
        vc = float(params.yukawa_velocity / torch.sqrt(time))
    return (float(sco), float(vc), float(params.cross_section_vel_scale),
            float(params.cross_section_pow_law))


def sidm_gated_plain(rows, cand, ncand, hs, dts, tid, salt: int, time,
                     sigma_co, params: SidmParams, box: float = 0.0,
                     block: int = 32768):
    """Plain PyTorch version of ``sidm_gated``: JAX's dense tile over the
    targets ``tid``, each over its first ncand candidate columns."""
    n, K = cand.shape
    dtype = rows.dtype
    ptot = torch.zeros(n + 1, dtype=dtype, device=rows.device)
    cnt = torch.zeros(n + 1, dtype=torch.int32, device=rows.device)
    bestk = torch.full((n + 1,), float("-inf"), dtype=torch.float32,
                       device=rows.device)
    bestj = torch.full((n + 1,), -1, dtype=torch.int32, device=rows.device)
    tid = tid[tid >= 0].long()
    for b0 in range(0, tid.numel(), block):
        t = tid[b0:b0 + block]
        if t.numel() == 0:
            continue
        Kt = max(int(ncand[t].max()), 1)
        trow = rows[t]
        th, tdt = hs[t], dts[t]
        cj = cand[t, :Kt]
        cv = (cj != IMAX) & (torch.arange(Kt, device=rows.device)[None, :]
                             < ncand[t][:, None])
        cjc = torch.clamp(torch.where(cv, cj, torch.zeros_like(cj)), 0,
                          n - 1).long()
        jrow = rows[cjc]
        d = [min_image(trow[:, None, c] - jrow[..., c], box)
             for c in range(3)]
        r = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        ok = cv & (r < th[:, None]) & ~(jrow[..., 7] >= 8.0)
        h_safe = torch.clamp(th, min=1e-30)[:, None]
        wk = sph_kernel(r / h_safe) / h_safe ** 3
        w = [trow[:, None, 3 + c] - jrow[..., 3 + c] for c in range(3)]
        rv = torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
        sgv = sigma_v_product(rv, time, sigma_co, params.cross_section_type,
                              params.yukawa_velocity,
                              params.cross_section_vel_scale,
                              params.cross_section_pow_law, params.comoving)
        prob = torch.where(ok, 0.5 * jrow[..., 6] * wk * sgv * tdt[:, None],
                           torch.zeros_like(wk))
        key = torch.where(
            prob > 0,
            torch.log(torch.clamp(prob, min=1e-37)).to(torch.float32)
            + pair_gumbel(t[:, None], cjc, salt),
            torch.full_like(wk, float("-inf"), dtype=torch.float32))
        km = torch.max(key, dim=-1).values
        jm = torch.max(torch.where(key == km[:, None], cjc,
                                   torch.full_like(cjc, -1)), dim=-1).values
        jm = torch.where(torch.isfinite(km), jm, torch.full_like(jm, -1))
        ptot[t] = torch.sum(prob, dim=-1)
        cnt[t] = torch.sum(ok, dim=-1).to(torch.int32)
        bestk[t] = km
        bestj[t] = jm.to(torch.int32)
    return ptot[:n], cnt[:n], bestk[:n], bestj[:n]


def sidm_gated(rows, cand, ncand, hs, dts, tid, salt: int, time, sigma_co,
               params: SidmParams, box: float = 0.0):
    """The gated DSMC tile (``_eval_gated``'s ``tile`` :434-484) over the
    targets ``tid`` (sorted ids, -1 = unused; ``gated_targets``). rows (n,
    8) sorted [pos3 vel3 mass aux]; cand (n, K) with live counts ncand; hs
    the targets' search radii, dts their dt_h0; box > 0: minimum-image
    distances. Returns sorted-order (ptot, cnt, best key, best partner);
    targets not in tid keep (0, 0, -inf, -1). On a CUDA tensor two
    launches of ``csrc/sidm_gated.cu``: the (n,) outputs' fill, then the
    tile (16 lanes a target)."""
    if not rows.is_cuda:
        return sidm_gated_plain(rows, cand, ncand, hs, dts, tid, salt, time,
                                sigma_co, params, box)
    from .._build import check_cuda, kernels_lib, launch_args
    n, K = cand.shape
    T = tid.shape[0]
    check_cuda("sidm_gated", rows=(rows, torch.float32, (n, 8)),
               cand=(cand, torch.int32, (n, K)),
               ncand=(ncand, torch.int32, (n,)),
               hs=(hs, torch.float32, (n,)), dts=(dts, torch.float32, (n,)),
               tid=(tid, torch.int32, (T,)))
    dev = rows.device
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32,
                                                          device=dev)
    ptot, cnt = torch.empty(n, **f32), torch.empty(n, **i32)
    bestk, bestj = torch.empty(n, **f32), torch.empty(n, **i32)
    sco, vc, vs, pl = _gated_consts(time, sigma_co, params)
    err = kernels_lib().sidm_gated_launch(*launch_args(
        rows, cand, n, K, ncand, hs, dts, tid, T, int(salt) & 0xFFFFFFFF,
        int(params.cross_section_type), sco, vc, vs, pl, float(box), ptot,
        cnt, bestk, bestj))
    if err:
        raise RuntimeError(f"sidm_gated kernel launch failed: CUDA error "
                           f"{err}")
    sidm_gated.launches += 1
    return ptot, cnt, bestk, bestj


sidm_gated.launches = 0


def gated_caps(n: int, rcfg: RangeListConfig):
    """(ngc, ntail, kd): the gated and tail capacities and the tier split,
    as ``sidm_scatter_lists`` sizes them."""
    ngc = int(rcfg.gated_frac * n)
    ngc = max(4096, -(-ngc // 4096) * 4096)
    ntail = int(rcfg.tail_cap) or int(rcfg.tail_frac * ngc)
    ntail = max(4096, -(-ntail // 4096) * 4096)
    return ngc, ntail, min(int(rcfg.k_dense), rcfg.k_cap)


def eval_gated(rows, cand, ncand, hs, dts, salt: int, time, sigma_co,
               params: SidmParams, ngc: int, ntail: int = 0, kd: int = 0,
               box: float = 0.0):
    """``_eval_gated``: the gated targets (hs > 0) in their tiers, through
    ``sidm_gated``. Returns sorted-order (ptot, cnt, best key, best partner,
    ovf2 (2,) int64)."""
    tid, ovf2 = gated_targets(hs, ncand, cand.shape[1], ngc, ntail, kd)
    ptot, cnt, bestk, bestj = sidm_gated(rows, cand, ncand, hs, dts, tid,
                                         salt, time, sigma_co, params, box)
    return ptot, cnt, bestk, bestj, ovf2


def candidates_valid(cands: SidmCandidates, pos_sorted, h_eff_sorted):
    """Worst-case validity margin: positive = some particle's current
    search ball may exceed its recorded candidate ball."""
    d = pos_sorted - cands.pos_ref
    md = torch.sqrt(torch.max(torch.sum(d * d, dim=-1)))
    slack = cands.r_ref - h_eff_sorted
    return 2.0 * md - torch.min(torch.where(cands.r_ref > 0, slack,
                                            torch.full_like(slack,
                                                            float("inf"))))


def sidm_scatter_lists(p, pos_pred, tree: Octree, cands: SidmCandidates,
                       time, active, vmax, key, params: SidmParams,
                       rcfg: Optional[RangeListConfig] = None,
                       salt: int = 0, box: float = 0.0):
    """One step's DSMC from the cached candidate lists (``box`` > 0: the
    periodic box). Returns (particles
    with the kicks in ``dvel``, n_scattered, validity margin, ovf2 (2,),
    info): info as ``tree_sidm_finish``'s (the step's kicks, accepted set,
    resolver rounds; ``events`` with ``params.log_events``) plus the
    pass's sorted-order outputs. n_scattered,
    the margin and ovf2 are device tensors (no host read)."""
    rcfg = rcfg or RangeListConfig()
    n = pos_pred.shape[0]
    rows, hs, dts, _, sigma_co, scan, h_eff, p_max, u = tree_sidm_prep(
        p, pos_pred, tree.perm, time, active, vmax, key, params)
    # validity by construction: each target's radius clamped to what its
    # recorded candidate ball still covers after the drift since record
    d = tree.pos_s - cands.pos_ref
    md = torch.sqrt(torch.max(torch.sum(d * d, dim=-1)))
    slack = torch.clamp(cands.r_ref - 2.0 * md, min=0.0)
    hs = torch.minimum(hs, slack).contiguous()
    ngc, ntail, kd = gated_caps(n, rcfg)
    ptot_t, cnt_t, best_t, bj_t, ovf_g = eval_gated(
        rows, cands.cand, cands.ncand, hs, dts, salt, time, sigma_co,
        params, ngc, ntail, kd, box)
    inv = torch.empty_like(tree.perm)
    inv[tree.perm] = torch.arange(n, device=inv.device)
    p2, n_scat, info = tree_sidm_finish(
        p, pos_pred, tree.perm, inv, ptot_t, cnt_t, bj_t, time, active,
        scan, p_max, u, key, params)
    viol = candidates_valid(cands, tree.pos_s, h_eff[tree.perm])
    info.update(rows=rows, hs=hs, dts=dts, ptot=ptot_t, cnt=cnt_t,
                bestk=best_t, bestj=bj_t, ngc=ngc, ntail=ntail, kd=kd,
                sigma_co=sigma_co)
    return p2, n_scat, viol, ovf_g, info


def h_eff_all(p, params: SidmParams):
    """Per-particle enumeration radius h_eff for all collisionless
    particles (the ungated twin of ``tree_sidm_prep``'s)."""
    return h_eff_of(p, p.is_collisionless & p.valid)


def record_candidates_from_particles(p, pos_pred, tree: Octree, *, skin=0.0,
                                     params: SidmParams,
                                     cfg: Optional[FusedConfig] = None,
                                     rcfg: Optional[RangeListConfig] = None,
                                     box: float = 0.0, on_walk=None,
                                     on_emit=None) -> SidmCandidates:
    """Pack the SIDM rows and record candidate lists for the current tree
    topology."""
    col = p.is_collisionless & p.valid
    rows = sidm_rows(p, pos_pred, tree.perm)
    h_all = torch.where(col, h_eff_all(p, params),
                        torch.zeros_like(p.hsml_vd))[tree.perm]
    typ = torch.where(col, p.ptype, torch.full_like(p.ptype, -9))[tree.perm]
    valid_sorted = (torch.where(p.valid, p.mass,
                                torch.zeros_like(p.mass)) > 0)[tree.perm]
    return record_candidates(tree, rows, h_all, typ.to(torch.int32),
                             valid_sorted, skin=skin, cfg=cfg, rcfg=rcfg,
                             box=box, on_walk=on_walk, on_emit=on_emit)
