"""The DSMC pass around the pair search (port of
``sidm_tpu/ops/sidm_tree.py``: ``_mix32`` :198, ``_pair_gumbel`` :210,
``_tree_sidm_prep`` :303, ``_tree_sidm_finish`` :364; JAX's
``_HSML_PARAMS`` :667, the parameters of its count-only passes, has no
counterpart: the port's count mode takes none).

Per active collisionless particle i (dt = 2 (t - CurrentTime)):
``tree_sidm_prep`` applies the reference's first-stage gate (P_max =
C_Pmax m_i h_i^-3 dt against one uniform, sidm.c:338-346) plus a small
maintenance sample that keeps the hsml controller fed, and gives only the
gated targets a search radius. The pair search (``list_range``) returns,
per target in sorted order, P_tot = sum_j P_j, the neighbour count and the
Gumbel-max partner. ``tree_sidm_finish`` decides the scatter (the same
uniform against P_tot), resolves conflicts, applies the type-4 angular
rejection and writes the pair kicks into ``dvel`` (``advance`` applies
them), and steps the hsml controller toward DesNumNgb.
"""

from __future__ import annotations

import dataclasses

import torch

from ..constants import SCAT_KERNEL_FACTOR
from ..cosmo import drift_factor
from ..rng import M32, mul32, particle_uniforms, random_directions
from ..sidm_common import cross_section_co, sidm_cmax
from .sidm import (SidmParams, collect_events, perp_unit,
                   resolve_conflicts_compact)


def mix32(a, b, c: int):
    """uint32 hash of (a, b, c), as int64 in [0, 2^32): a, b int tensors
    (taken mod 2^32), c a Python int."""
    u = (mul32(a.to(torch.int64) & M32, 0x9E3779B1)
         ^ mul32(b.to(torch.int64) & M32, 0x85EBCA77)
         ^ ((c & M32) * 0xC2B2AE3D & M32))
    u = u ^ (u >> 16)
    u = mul32(u, 0x7FEB352D)
    u = u ^ (u >> 15)
    u = mul32(u, 0x846CA68B)
    return u ^ (u >> 16)


def pair_gumbel(i_idx, j_idx, salt: int):
    """Deterministic Gumbel noise per (target, neighbour, step) triple."""
    u = mix32(i_idx, j_idx, salt)
    uf = (u >> 8).to(torch.float32) * (1.0 / (1 << 24))
    uf = torch.clamp(uf, 1e-7, 1.0 - 1e-7)
    return -torch.log(-torch.log(uf))


def nanmedian(x):
    """``jnp.nanmedian`` of a 1-d tensor: the mean of the two middle
    values for an even count, as ``low*0.5 + high*0.5`` in the tensor's
    type (``torch.nanmedian`` returns the lower one); NaN when all are.
    On the device, without a host read."""
    isn = torch.isnan(x)
    c = torch.sum(~isn)
    v = torch.sort(torch.where(isn, torch.full_like(x, float("inf")),
                               x)).values
    lo = v[torch.clamp((c - 1) // 2, min=0)]
    hi = v[torch.clamp(c // 2, max=x.numel() - 1)]
    med = torch.where(c % 2 == 1, lo, lo * 0.5 + hi * 0.5)
    return torch.where(c > 0, med, torch.full_like(med, float("nan")))


def h_eff_of(p, valid_col):
    """SCAT_KERNEL_FACTOR * hsml_vd capped at 8x the median over
    ``valid_col`` (outskirt particles would otherwise search balls of the
    system's size; the rate estimate is unbiased for any radius)."""
    h_med = nanmedian(torch.where(valid_col, p.hsml_vd,
                                  torch.full_like(p.hsml_vd, float("nan"))))
    h_cap = torch.nan_to_num(8.0 * h_med, nan=float("inf"))
    return torch.minimum(SCAT_KERNEL_FACTOR * p.hsml_vd,
                         torch.clamp(h_cap, min=1e-30))


def sidm_rows(p, pos_pred, perm):
    """(n, 8) sorted rows [pos3, vel3, mass, aux], aux = type + 8 pending
    (a particle with a kick not yet applied is no partner)."""
    has_pending = torch.any(p.dvel != 0.0, dim=-1)
    aux = (torch.clamp(p.ptype, 0, 7).to(pos_pred.dtype)
           + 8.0 * has_pending.to(pos_pred.dtype))
    return torch.cat([pos_pred, p.vel, p.mass[:, None], aux[:, None]],
                     dim=1)[perm].contiguous()


def tree_sidm_prep(p, pos_pred, perm, time, active, vmax, key,
                   params: SidmParams):
    """Sorted-space inputs of the pair search, with the P_max pre-gate.
    Returns (rows, hs, dts, typs, sigma_co, scan, h_eff, p_max, u): hs
    the gated search radius (0 = not gated) and dts the dt_h0, both in
    sorted order; scan, h_eff, p_max and the particles' four uniforms u
    (N, 4) in original order (JAX returns u[:, 0] and draws u again in
    its finish; the draws are the same)."""
    dtype = pos_pred.dtype
    has_pending = torch.any(p.dvel != 0.0, dim=-1)
    rows = sidm_rows(p, pos_pred, perm)
    dt = 2.0 * (time - p.current_time)
    s_inv = drift_factor(time, params.hubble, params.omega0,
                         params.omega_lambda, params.comoving)
    dt_h0 = torch.where(active, dt, torch.zeros_like(dt)) * s_inv
    sigma_co = cross_section_co(time, params.cross_section_internal,
                                params.cross_section_type, params.comoving)
    col = p.is_collisionless & p.valid
    elig = active & col & (dt_h0 > 0) & ~has_pending
    h_eff = h_eff_of(p, col)
    c_pmax = sidm_cmax(
        time, vmax, params.cross_section_internal,
        params.cross_section_type, params.yukawa_velocity,
        params.cross_section_vel_scale, params.des_num_ngb,
        params.max_num_ngb_dev, params.hubble, params.omega0,
        params.omega_lambda, params.comoving, per_dt_h0=True)
    u = particle_uniforms(key, p.pid, 4).to(dtype)
    rand = u[:, 0]
    hinv3 = torch.where(h_eff > 0, 1.0 / torch.clamp(h_eff, min=1e-30) ** 3,
                        torch.zeros_like(h_eff))
    p_max = c_pmax * p.mass * hinv3 * dt_h0
    maintenance = u[:, 3] < params.maintenance_rate
    scan = elig & ((rand < p_max) | maintenance)
    hs = torch.where(scan, h_eff, torch.zeros_like(h_eff))[perm]
    dts = dt_h0[perm]
    typs = torch.where(scan, p.ptype, torch.full_like(p.ptype, -9))[perm]
    return (rows, hs.contiguous(), dts.contiguous(), typs, sigma_co, scan,
            h_eff, p_max, u)


def tree_sidm_finish(p, pos_pred, perm, inv, ptot_t, cnt_t, bj_t, time,
                     active, scan, p_max, u, key, params: SidmParams):
    """Scatter decision, conflict resolution, kicks and the hsml
    controller. ptot_t, cnt_t and bj_t (partner, a sorted index, -1 for
    none) are in sorted order; u the prep's uniforms; pos_pred the
    predicted positions (read only for the scatter log). Returns
    (particles, n_scattered (a 0-d tensor), info): info holds the kicks of
    this step (``dvel`` added), the accepted set, the proposals, the
    resolver's rounds and its dropped proposers, and with
    ``params.log_events`` the step's ``events`` (``collect_events``)."""
    n = p.pos.shape[0]
    dtype = p.pos.dtype
    ptot = ptot_t[inv]
    cnt = cnt_t[inv]
    bj_sorted = bj_t[inv]
    partner = torch.where(bj_sorted >= 0,
                          perm[torch.clamp(bj_sorted.long(), 0, n - 1)],
                          torch.full_like(perm, -1))
    has_pending = torch.any(p.dvel != 0.0, dim=-1)
    dt = 2.0 * (time - p.current_time)
    s_inv = drift_factor(time, params.hubble, params.omega0,
                         params.omega_lambda, params.comoving)
    dt_h0 = torch.where(p.valid, dt, torch.zeros_like(dt)) * s_inv
    rand = u[:, 0]
    col = p.is_collisionless & p.valid
    pj0 = torch.clamp(partner, 0, n - 1)
    hit = (col & ~has_pending & active & scan & (rand < p_max)
           & (rand < ptot) & (partner >= 0) & ~has_pending[pj0])

    # type-4 angular rejection (sidm.c:391-438)
    cos_theta = None
    if params.cross_section_type == 4:
        vc = (params.yukawa_velocity / torch.sqrt(time) if params.comoving
              else params.yukawa_velocity)
        rel0 = p.vel - p.vel[pj0]
        rv0 = torch.sqrt(torch.sum(rel0 * rel0, dim=-1))
        beta = rv0 / vc
        cos_theta = 2.0 * u[:, 2] - 1.0
        sin22 = 0.5 * (1.0 - cos_theta)
        denom = 1.0 + beta * beta * sin22
        hit = hit & (u[:, 1] < 1.0 / (denom * denom)) & (rv0 > 0)

    proposal = torch.where(hit, partner, torch.full_like(partner, -1))
    accepted, rounds, dropped, ti, acc_c = resolve_conflicts_compact(
        proposal, n)

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
    # the partners' recoil, over the proposers (JAX adds zeros for the
    # rest, at index 0)
    kick = kick.index_add(0, pj[ti], torch.where(
        acc_c[:, None], -(mi / msum)[ti, None] * delta[ti], zero[ti]))
    n_scat = torch.sum(accepted)

    # hsml controller toward DesNumNgb (density.c:304-325 analog); only
    # targets scanned this step update
    upd = col & active & scan & (dt_h0 > 0)
    ratio = (params.des_num_ngb
             / torch.clamp(cnt, min=1).to(dtype)) ** (1.0 / 3.0)
    h_new = p.hsml_vd * torch.clamp(ratio, 0.7, 1.3)
    p = dataclasses.replace(
        p, dvel=p.dvel + kick,
        hsml_vd=torch.where(upd, h_new, p.hsml_vd),
        ngb_vd=torch.where(upd, cnt.to(torch.int32), p.ngb_vd))
    info = dict(kick=kick, accepted=accepted, proposal=proposal,
                rounds=rounds, dropped=dropped)
    if params.log_events:
        info["events"] = collect_events(p, pos_pred, time, accepted, pj,
                                        dv_i, params.event_cap)
    return p, n_scat, info
