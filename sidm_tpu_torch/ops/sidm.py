"""DSMC pair scattering: the pieces shared by the scattering engines and
the hash-grid engine of the single-program step (port of
``sidm_tpu/ops/sidm.py``: ``SidmParams`` :58, ``make_sidm_step`` :78,
``update_hsml`` :102, ``sidm_scatter`` :135, ``_collect_events`` :311,
``_perp_unit`` :340, ``_resolve_conflicts`` :353 and
``_resolve_conflicts_compact`` :392).

The hash engine (``sidm_scatter``) builds the neighbour table
(``ops/neighbors.py``) at the predicted positions with base cell size the
smallest current smoothing length, refreshes every active particle's
hsml_vd as its DesNumNgb-th neighbour radius (``update_hsml``: kernel H1),
applies the first-stage gate (P_max = C_Pmax m_i h_i^-3 dt against one
uniform, sidm.c:338-346), and scans each gated target's candidates in
order for the first whose running probability sum reaches the same
uniform (``hash_scan``: kernel H2, sidm.c:352-388); then the type-4
angular rejection, the conflict resolution and the kicks, as JAX does.

The conflict resolution is the JAX package's deterministic greedy matching
by target index: a proposal (i -> j) executes when i is the lowest-index
pending proposal touching either i or j, and proposals whose endpoints get
taken are cancelled. JAX runs the rounds in a ``while_loop``; here they run
as a host loop until nothing is pending, one device-to-host read per round
(the proposers are a few thousand per step, the rounds a handful).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..constants import SCAT_KERNEL_FACTOR
from ..cosmo import drift_factor
from ..kernels import sph_kernel
from ..rng import particle_uniforms, random_directions
from ..sidm_common import cross_section_co, sidm_cmax, sigma_v_product
from .neighbors import (NeighborTable, build_table, candidate_blocks,
                        knn_radius, make_payload, min_image)


class SidmParams(NamedTuple):
    """The JAX ``SidmParams``. ``cap``, ``block`` and ``n_levels`` are the
    hash engine's: the rows read per stencil bucket (``Simulation`` grows
    it to the demand), the queries of a plain-version block and the grid's
    levels. ``log_events``: the scatter log's per-event records, the first
    ``event_cap`` of a step (``collect_events``)."""
    cross_section_internal: float
    cross_section_type: int
    yukawa_velocity: float
    cross_section_vel_scale: float
    cross_section_pow_law: float
    des_num_ngb: int
    max_num_ngb_dev: int
    comoving: bool
    hubble: float
    omega0: float
    omega_lambda: float
    cap: int = 96
    block: int = 1024
    n_levels: int = 12
    log_events: bool = False     # SCATTERLOG (Makefile -DSCATTERLOG)
    event_cap: int = 4096        # max logged events per step
    maintenance_rate: float = 0.03  # hsml-controller sampling for ungated


def collect_events(p, pos_pred, time, accepted, pj, dv_i, cap: int):
    """The step's SCATTERLOG records (struct scatlog, nbody/sidm.h:1-10),
    the first ``cap`` accepted targets in particle order, on the device and
    without a host read: (rec (cap, 18) [time, h1, h2, x1(3), x2(3),
    v1(3), v2(3), dv(3)] in the state's dtype, ids (cap, 2) int32 [id1,
    id2], count = min(accepted, cap) as a 0-d tensor). Rows past the count
    are 0; the accepted targets past ``cap`` are not recorded (JAX drops
    them silently; ``Simulation`` counts them). ``p`` is the state after
    the pass (its controller's ``hsml_vd``), as JAX takes it."""
    n = accepted.shape[0]
    cap = min(int(cap), n)
    n_acc = torch.sum(accepted)
    slot = torch.cumsum(accepted.long(), 0) - 1
    slot = torch.where(accepted & (slot < cap), slot,
                       torch.full_like(slot, cap))
    i = torch.full((cap + 1,), n, dtype=torch.long, device=accepted.device)
    i = i.scatter_(0, slot, torch.arange(n, device=accepted.device))[:cap]
    valid = i < n
    i = torch.clamp(i, max=n - 1)
    j = pj[i].long()
    rec = torch.cat([
        torch.as_tensor(time, dtype=pos_pred.dtype,
                        device=pos_pred.device).reshape(1, 1).expand(cap, 1),
        p.hsml_vd[i][:, None], p.hsml_vd[j][:, None], pos_pred[i],
        pos_pred[j], p.vel[i], p.vel[j], dv_i[i]], dim=1)
    rec = torch.where(valid[:, None], rec, torch.zeros_like(rec))
    ids = torch.stack([p.pid[i], p.pid[j]], dim=1).to(torch.int32)
    ids = torch.where(valid[:, None], ids, torch.zeros_like(ids))
    return rec, ids, torch.clamp(n_acc, max=cap)


def perp_unit(a, b):
    """Unit vector perpendicular to a (and b), cf. perp() sidm.c:29-53;
    for a parallel to b (or zero) any perpendicular of a."""
    c = torch.linalg.cross(a, b)
    norm = torch.sqrt(torch.sum(c * c, dim=-1, keepdim=True))
    ex = torch.zeros_like(a)
    ex[..., 0] = 1.0
    alt = torch.linalg.cross(a, ex)
    alt_n = torch.sqrt(torch.sum(alt * alt, dim=-1, keepdim=True))
    use_alt = norm < 1e-20
    c = torch.where(use_alt, alt, c)
    norm = torch.where(use_alt, alt_n, norm)
    return c / torch.clamp(norm, min=1e-30)


def resolve_conflicts_compact(proposal, n: int, cap: int = 65536):
    """Accepted set of the proposals (``proposal[i]`` = partner of i, -1
    for none): the JAX package's greedy rounds over the first ``cap``
    proposers in index order. Returns (accepted (n,) bool, rounds, the
    proposers past ``cap``, which JAX drops silently: ROADMAP C.3, the
    proposers taken (P,) and which of them were accepted (P,))."""
    dev = proposal.device
    ti = torch.nonzero(proposal >= 0).flatten()
    dropped = max(int(ti.numel()) - cap, 0)
    ti = ti[:cap]
    tj = torch.clamp(proposal[ti].long(), 0, n - 1)
    pending = torch.ones(ti.numel(), dtype=torch.bool, device=dev)
    acc = torch.zeros_like(pending)
    rounds = 0
    while ti.numel() and bool(pending.any()):
        rounds += 1
        prop_i = torch.where(pending, ti, torch.full_like(ti, n))
        touch = torch.full((n,), n, dtype=ti.dtype, device=dev)
        touch.scatter_reduce_(0, ti, prop_i, "amin")
        touch.scatter_reduce_(0, tj, prop_i, "amin")
        safe = pending & (touch[ti] == ti) & (touch[tj] == ti)
        acc |= safe
        taken = torch.zeros(n, dtype=torch.bool, device=dev)
        taken[ti[safe]] = True
        taken[tj[safe]] = True
        pending = pending & ~safe & ~taken[ti] & ~taken[tj]
    accepted = torch.zeros(n, dtype=torch.bool, device=dev)
    accepted[ti] = acc
    return accepted, rounds, dropped, ti, acc


def resolve_conflicts(proposal, n: int):
    """JAX's uncapped ``_resolve_conflicts``: the compact rounds over every
    proposer (the same accepted set; tests/test_torch_sidm_hash.py holds
    them equal). Returns ``resolve_conflicts_compact``'s tuple."""
    return resolve_conflicts_compact(proposal, n, cap=max(int(n), 1))


# ------------------------------------------------------------ hash engine


class HashScan(NamedTuple):
    """``hash_scan``'s result, (n,) in particle order: the partner (-1 for
    none) and hit of each gated target, its ``need`` (largest bucket count
    reached), ``clip`` (level clipped) and ``scanned`` (rows read up to and
    including the crossing). The plain version also gives ``ok`` (valid
    candidates up to the crossing) and ``margin``: |running sum - uniform|
    / uniform at the nearest boundary of the crossing (the gap to the
    total for a target with no hit), inf for the others; a partner that
    differs at a margin within float rounding is a near-tie."""
    partner: torch.Tensor
    hit: torch.Tensor
    need: torch.Tensor
    clip: torch.Tensor
    scanned: torch.Tensor
    ok: Optional[torch.Tensor] = None
    margin: Optional[torch.Tensor] = None


def hash_scan_plain(table: NeighborTable, pos, vel, hs, ptype, rand, dts,
                    tid, time, sigma_co, params: SidmParams, cap: int,
                    keys: Optional[list] = None) -> HashScan:
    """Plain PyTorch version of ``hash_scan``: JAX's ``scan_block`` on the
    targets ``tid``, on the compact layout (``candidate_blocks``: JAX's
    order without the masked slots, whose terms are 0). ``keys``: a list
    that receives their deduplicated bucket keys, for
    ``bounds.scan_work``."""
    n, dev = pos.shape[0], pos.device
    i32 = dict(dtype=torch.int32, device=dev)
    partner = torch.full((n,), -1, **i32)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    need, scanned, ok_n = (torch.zeros(n, **i32) for _ in range(3))
    clip = torch.zeros(n, dtype=torch.bool, device=dev)
    margin = torch.full((n,), float("inf"), dtype=pos.dtype, device=dev)
    tid = tid.long()
    blocks, nd, cl, _ = candidate_blocks(table, pos[tid], ptype[tid], hs[tid],
                                         cap=cap, keys=keys)
    need[tid] = nd.to(torch.int32)
    clip[tid] = cl
    for b in blocks:
        t = tid[b.sel]
        bpos, bh = pos[t], hs[t][:, None]
        rows, idx = table.rows[b.entry], table.sorted_part[b.entry]
        d = [min_image(rows[..., c] - bpos[:, None, c], table.box)
             for c in range(3)]
        r = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        ok = (b.mask & (r < bh) & (idx != t[:, None])
              & ~(rows[..., 7] >= 8.0))
        wk = sph_kernel(r / bh) / (bh * bh * bh)
        w = [vel[t][:, None, c] - rows[..., 3 + c] for c in range(3)]
        rv = torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
        sv = sigma_v_product(rv, time, sigma_co, params.cross_section_type,
                             params.yukawa_velocity,
                             params.cross_section_vel_scale,
                             params.cross_section_pow_law, params.comoving)
        prob = torch.where(ok, 0.5 * rows[..., 6] * wk * sv
                           * dts[t][:, None], torch.zeros_like(wk))
        cum = torch.cumsum(prob, dim=1)
        u = rand[t]
        crossed = cum >= u[:, None]
        anyc = torch.any(crossed, dim=1)
        first = torch.argmax(crossed.to(torch.int8), dim=1)
        pj = idx.gather(1, first[:, None])[:, 0]
        # JAX's cum >= rand holds at its slot 0 for a uniform of 0
        zero = u == 0.0
        pj = torch.where(zero, b.first, pj)
        anyc = anyc | zero
        first = torch.where(zero, torch.zeros_like(first), first)
        partner[t] = torch.where(anyc, pj, torch.full_like(pj, -1)).to(
            torch.int32)
        hit[t] = anyc
        slot = torch.arange(cum.shape[1], device=dev)[None, :]
        upto = torch.where(anyc[:, None], slot <= first[:, None],
                           torch.ones_like(crossed))
        scanned[t] = torch.where(zero, torch.ones_like(first),
                                 torch.sum(upto & b.real, dim=1)).to(
            torch.int32)
        ok_n[t] = torch.sum(upto & ok, dim=1).to(torch.int32)
        hi = cum.gather(1, first[:, None])[:, 0]
        lo = torch.where(first > 0, cum.gather(
            1, torch.clamp(first - 1, min=0)[:, None])[:, 0],
            torch.zeros_like(hi))
        total = cum[:, -1] if cum.shape[1] else torch.zeros_like(u)
        gap = torch.where(anyc, torch.minimum(hi - u, u - lo), u - total)
        margin[t] = torch.abs(gap) / torch.clamp(u, min=1e-30)
    return HashScan(partner, hit, need, clip, scanned, ok_n, margin)


def hash_scan(table: NeighborTable, pos, vel, hs, ptype, rand, dts, tid,
              time, sigma_co, params: SidmParams, cap: int) -> HashScan:
    """The hash engine's partner scan over the gated targets ``tid``: each
    target's candidates (``candidate_blocks`` at its h, up to ``cap`` a
    bucket) in JAX's order, valid when of its type, r < h, not itself and
    with no pending kick, their terms 0.5 m_j W(r/h)/h^3 sigma(v) v dt
    summed in order; the partner is the first whose running sum reaches
    ``rand``. On a CUDA tensor one launch of ``csrc/hash_scan.cu`` (a warp
    a target), partners equal to the plain version's except at near-ties
    (``HashScan.margin``)."""
    if not pos.is_cuda:
        return hash_scan_plain(table, pos, vel, hs, ptype, rand, dts, tid,
                               time, sigma_co, params, cap)
    from .._build import check_cuda, kernels_lib, launch_args
    from .list_range import _gated_consts
    n, T = pos.shape[0], tid.shape[0]
    i32 = dict(dtype=torch.int32, device=pos.device)
    partner = torch.full((n,), -1, **i32)
    hit, need, clip, scanned = (torch.zeros(n, **i32) for _ in range(4))
    if T == 0:      # no gated target: nothing to launch
        return HashScan(partner, hit.bool(), need, clip.bool(), scanned)
    LN, H, L = table.sorted_part.shape[0], table.n_hash, table.n_levels
    tid = tid.to(torch.int32).contiguous()
    check_cuda("hash_scan", rows=(table.rows, torch.float32, (LN, 8)),
               sorted_part=(table.sorted_part, torch.int32, (LN,)),
               bstart=(table.bucket_start, torch.int32, (L * H,)),
               bcount=(table.bucket_count, torch.int32, (L * H,)),
               pos=(pos, torch.float32, (n, 3)),
               vel=(vel, torch.float32, (n, 3)),
               hs=(hs, torch.float32, (n,)), ptype=(ptype, torch.int32, (n,)),
               rand=(rand, torch.float32, (n,)),
               dts=(dts, torch.float32, (n,)), tid=(tid, torch.int32, (T,)))
    sco, vc, vs, pl = _gated_consts(time, sigma_co, params)
    err = kernels_lib().hash_scan_launch(*launch_args(
        table.rows, table.sorted_part, LN, table.bucket_start,
        table.bucket_count, table.geom, L, H, float(table.box), pos, vel, hs,
        ptype, rand, dts, tid, T, int(cap), int(params.cross_section_type),
        sco, vc, vs, pl, partner, hit, need, clip, scanned))
    if err:
        raise RuntimeError(f"hash_scan kernel launch failed: CUDA error "
                           f"{err}")
    hash_scan.launches += 1
    return HashScan(partner, hit.bool(), need, clip.bool(), scanned)


hash_scan.launches = 0


def sidm_params(cfg, units) -> SidmParams:
    """The SidmParams of a configuration (``make_sidm_step``'s)."""
    return SidmParams(
        cross_section_internal=units.CrossSectionInternal,
        cross_section_type=cfg.CrossSectionType,
        yukawa_velocity=cfg.YukawaVelocity,
        cross_section_vel_scale=cfg.CrossSectionVelScale,
        cross_section_pow_law=cfg.CrossSectionPowLaw,
        des_num_ngb=cfg.DesNumNgb,
        max_num_ngb_dev=cfg.MaxNumNgbDeviation,
        comoving=bool(cfg.ComovingIntegrationOn),
        hubble=units.Hubble, omega0=cfg.Omega0,
        omega_lambda=cfg.OmegaLambda, log_events=bool(cfg.ScatterLog))


def make_sidm_step(cfg, units):
    """The hash engine's pass for a configuration: fn(p, pos_pred, time,
    active, vmax, key, cap=None) -> ``sidm_scatter``'s return with
    ``return_info``."""
    params = sidm_params(cfg, units)
    box = cfg.BoxSize if cfg.PeriodicBoundariesOn else 0.0

    def fn(p, pos_pred, time, active, vmax, key, cap=None):
        return sidm_scatter(p, pos_pred, time, active, vmax, key, params,
                            box=box, cap=cap, return_info=True)

    return fn


def update_hsml(p, pos_pred, table: NeighborTable, active,
                params: SidmParams, cap: Optional[int] = None):
    """Refresh hsml_vd and ngb_vd of the active collisionless particles as
    the DesNumNgb-th neighbour radius at the predicted positions (replaces
    setup_nbr_sidm + sidm_ensure_neighbours), three iterations from the
    current lengths (2 s0 where none). Returns (particles, Knn)."""
    warm = torch.where(p.hsml_vd > 0, p.hsml_vd, 2.0 * table.s0)
    r = knn_radius(table, pos_pred, p.ptype, warm.contiguous(),
                   params.des_num_ngb, cap=params.cap if cap is None else cap,
                   n_iter=3)
    upd = p.is_collisionless & active
    return dataclasses.replace(
        p, hsml_vd=torch.where(upd, r.h.to(p.hsml_vd.dtype), p.hsml_vd),
        ngb_vd=torch.where(upd, r.cnt, p.ngb_vd).to(torch.int32)), r


def hash_base_cell(p, pos_pred, params: SidmParams, box: float = 0.0):
    """The hash engine's table's base cell size (``base_cell`` at
    ``params.des_num_ngb``)."""
    return base_cell(p, pos_pred, params.des_num_ngb, box)


def base_cell(p, pos_pred, des_num_ngb: int, box: float = 0.0):
    """A hash table's base cell size: the smallest current smoothing length
    (floored at 1e-12), or at a cold start (no length set) half the
    k-neighbour radius of a uniform distribution at the mean density. A
    0-d tensor, computed on the device."""
    dtype = pos_pred.dtype
    valid = p.valid
    if box:
        vol = torch.tensor(float(box), dtype=dtype, device=pos_pred.device) ** 3
    else:
        inf = torch.full_like(pos_pred, float("inf"))
        ext = (torch.max(torch.where(valid[:, None], pos_pred, -inf), 0).values
               - torch.min(torch.where(valid[:, None], pos_pred, inf),
                           0).values)
        vol = torch.prod(torch.clamp(ext, min=1e-10))
    n_valid = torch.clamp(torch.sum(valid), min=1)
    r_k = (3.0 * des_num_ngb * vol
           / (4.0 * torch.pi * n_valid)) ** (1.0 / 3.0)
    hpos = torch.where(p.hsml_vd > 0, p.hsml_vd,
                       torch.full_like(p.hsml_vd, float("inf")))
    hmin = torch.min(torch.where(p.is_collisionless, hpos,
                                 torch.full_like(hpos, float("inf"))))
    return torch.where(torch.isfinite(hmin), torch.clamp(hmin, min=1e-12),
                       (r_k / 2.0).to(dtype))


def sidm_scatter(p, pos_pred, time, active, vmax, key, params: SidmParams,
                 box: float = 0.0, cap: Optional[int] = None,
                 return_info: bool = False):
    """One DSMC pass of the hash engine (``sidm_scatter`` :135-308): the
    table at the predicted positions, the hsml refresh (``update_hsml``),
    the gate, the partner scan of the gated targets (``hash_scan``), the
    type-4 rejection, the conflict resolution (JAX's uncapped one) and
    the kicks (into ``dvel``, which ``advance`` applies). ``cap`` the rows
    read per bucket (default ``params.cap``, JAX's: reads past it are
    dropped as JAX drops them, and counted). Returns (particles,
    n_scattered (0-d tensor)); with ``params.log_events`` and no
    ``return_info`` also the step's events (JAX's return); with
    ``return_info`` a dict: the kicks, accepted set, proposals, resolver
    rounds, ``n_gated``, ``need`` (the largest bucket count a query or
    target reached), ``ngb_ovf`` (queries and targets that read a bucket
    past ``cap``), ``lvl_clip`` (those whose level was clipped), the
    ``knn`` and ``scan`` results, and ``events`` with
    ``params.log_events``."""
    n = pos_pred.shape[0]
    dtype = pos_pred.dtype
    cap = params.cap if cap is None else int(cap)
    s0 = hash_base_cell(p, pos_pred, params, box)
    has_pending = torch.any(p.dvel != 0.0, dim=-1)
    payload = make_payload(pos_pred, p.vel, p.mass, p.ptype,
                           flag=has_pending)
    table = build_table(pos_pred, p.ptype, p.valid, s0=s0, box=box,
                        n_levels=params.n_levels, payload=payload)
    p, knn = update_hsml(p, pos_pred, table, active, params, cap)

    dt = 2.0 * (time - p.current_time)
    s_inv = drift_factor(time, params.hubble, params.omega0,
                         params.omega_lambda, params.comoving)
    dt_h0 = torch.where(active, dt, torch.zeros_like(dt)) * s_inv
    sigma_co = cross_section_co(time, params.cross_section_internal,
                                params.cross_section_type, params.comoving)
    c_pmax = sidm_cmax(
        time, vmax, params.cross_section_internal, params.cross_section_type,
        params.yukawa_velocity, params.cross_section_vel_scale,
        params.des_num_ngb, params.max_num_ngb_dev, params.hubble,
        params.omega0, params.omega_lambda, params.comoving, per_dt_h0=True)
    eligible = (active & p.is_collisionless & p.valid & ~has_pending
                & (dt_h0 > 0))
    u = particle_uniforms(key, p.pid, 3).to(dtype)
    rand = u[:, 0].contiguous()
    h_scat = SCAT_KERNEL_FACTOR * p.hsml_vd
    hinv3 = torch.where(h_scat > 0, 1.0 / torch.clamp(h_scat, min=1e-30) ** 3,
                        torch.zeros_like(h_scat))
    p_max = c_pmax * p.mass * hinv3 * dt_h0
    gate = eligible & (p_max >= rand)

    tid = torch.nonzero(gate).flatten()
    scan = hash_scan(table, pos_pred.contiguous(), p.vel.contiguous(),
                     h_scat.contiguous(), p.ptype, rand, dt_h0.contiguous(),
                     tid, time, sigma_co, params, cap)
    partner, hit = scan.partner.long(), scan.hit

    # type-4 angular rejection (sidm.c:391-438)
    cos_theta = None
    if params.cross_section_type == 4:
        vc = (params.yukawa_velocity / torch.sqrt(time) if params.comoving
              else params.yukawa_velocity)
        pj0 = torch.clamp(partner, 0, n - 1)
        rel0 = p.vel - p.vel[pj0]
        rv0 = torch.sqrt(torch.sum(rel0 * rel0, dim=-1))
        beta = rv0 / vc
        cos_theta = 2.0 * u[:, 2] - 1.0
        sin22 = 0.5 * (1.0 - cos_theta)
        denom = 1.0 + beta * beta * sin22
        hit = hit & (u[:, 1] < 1.0 / (denom * denom)) & (rv0 > 0)

    proposal = torch.where(hit & (partner >= 0), partner,
                           torch.full_like(partner, -1))
    accepted, rounds, dropped, ti, acc_c = resolve_conflicts(proposal, n)

    pj = torch.clamp(proposal, 0, n - 1)
    rel = p.vel - p.vel[pj]
    rv = torch.sqrt(torch.sum(rel * rel, dim=-1))
    nhat = random_directions(key, p.pid).to(dtype)
    if params.cross_section_type == 4:
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
        nperp = perp_unit(rel, nhat)
        delta = (-rel + cos_theta[:, None] * rel
                 + (sin_t * rv)[:, None] * nperp)
    else:
        delta = -rel + rv[:, None] * nhat
    mi, mj = p.mass, p.mass[pj]
    msum = torch.clamp(mi + mj, min=1e-30)
    zero = torch.zeros_like(delta)
    dv_i = (mj / msum)[:, None] * delta
    kick = torch.where(accepted[:, None], dv_i, zero)
    kick = kick.index_add(0, pj[ti], torch.where(
        acc_c[:, None], -(mi / msum)[ti, None] * delta[ti], zero[ti]))
    n_scat = torch.sum(accepted)
    p = dataclasses.replace(p, dvel=p.dvel + kick)
    events = (collect_events(p, pos_pred, time, accepted, pj, dv_i,
                             params.event_cap) if params.log_events else None)
    if not return_info:
        return (p, n_scat) if events is None else (p, n_scat, events)
    upd = p.is_collisionless & active
    qn = upd & (knn.need > cap)
    tn = torch.zeros_like(qn)
    tn[tid] = scan.need[tid] > cap
    info = dict(kick=kick, accepted=accepted, proposal=proposal,
                rounds=rounds, dropped=dropped, n_gated=int(tid.numel()),
                need=torch.maximum(torch.max(torch.where(upd, knn.need, 0)),
                                   torch.max(scan.need)),
                ngb_ovf=torch.sum(qn) + torch.sum(tn),
                lvl_clip=torch.sum(upd & knn.clip) + torch.sum(scan.clip),
                knn=knn, scan=scan, tid=tid, table=table, cap=cap,
                scan_inputs=dict(hs=h_scat, rand=rand, dts=dt_h0,
                                 sigma_co=sigma_co))
    if events is not None:
        info["events"] = events
    return p, n_scat, info
