"""Shared SIDM cross-section math of the DSMC pass and the timestep
criteria (port of ``sidm_tpu/sidm_common.py``: ``cross_section_co`` :28,
``sigma_v_product`` :36, ``_vc`` :62, ``sidm_cmax`` :68; the per-step
salt, JAX's ``salt_u32`` :108, is a Python int here, masked where it is
used).

Cross-section types (sigma0 = CrossSectionInternal): 0 hard sphere, 1
Maxwellian sigma0/v, 2 Yukawa-like total sigma0/(1+(v/vc)^2)^2, 3 power
law sigma0 (v/v_scale)^alpha, 4 Yukawa angular (total bounded by sigma0,
the angle chosen by rejection after the partner is picked).
"""

from __future__ import annotations

import math

import torch

from .constants import BALL_INVERSE, SAFE_FACTOR


def cross_section_co(time, sigma_internal, cs_type, comoving):
    """Comoving-corrected sigma0 (sidm.c:226-316)."""
    if not comoving:
        return torch.full((), sigma_internal, dtype=time.dtype,
                          device=time.device)
    power = 2.5 if cs_type == 1 else 2.0
    return sigma_internal / time ** power


def sigma_v_product(rv, time, sigma_co, cs_type, yukawa_velocity,
                    vel_scale, pow_law, comoving):
    """sigma(v_rel) * v_rel in comoving-corrected internal units; times
    0.5 m_j W dt_h0 it is a neighbour's scattering probability
    (sidm.c:352-386). Written in the JAX package's order of operations."""
    if cs_type in (0, 4):
        return sigma_co * rv
    if cs_type == 1:
        return sigma_co * torch.ones_like(rv)
    if cs_type == 2:
        vc = _vc(time, yukawa_velocity, comoving)
        beta = rv / vc
        v_dep = 1.0 / (1.0 + beta * beta)
        return sigma_co * rv * v_dep * v_dep
    if cs_type == 3:
        rv_safe = torch.clamp(rv, min=1e-30)
        return sigma_co * rv * (rv_safe / vel_scale) ** pow_law
    raise ValueError(f"unknown CROSS_SECTION_TYPE {cs_type}")


def _vc(time, yukawa_velocity, comoving):
    if comoving:
        return yukawa_velocity / torch.sqrt(time)
    return torch.full((), yukawa_velocity, dtype=time.dtype,
                      device=time.device)


def sidm_cmax(time, vmax, sigma_internal, cs_type, yukawa_velocity, vel_scale,
              des_num_ngb, max_num_ngb_dev, hubble, omega0, omega_lambda,
              comoving, per_dt_h0: bool):
    """Upper bound C on (3/4pi)(Nngb+dev) max_v[sigma(v) v]; see the JAX
    docstring for the per_dt_h0 convention."""
    ngb_fac = SAFE_FACTOR * BALL_INVERSE * (des_num_ngb + max_num_ngb_dev)
    sigma_co = cross_section_co(time, sigma_internal, cs_type, comoving)
    if cs_type in (0, 4):
        bound = 2.0 * vmax * sigma_co
    elif cs_type == 1:
        bound = sigma_co
    elif cs_type == 2:
        vc = _vc(time, yukawa_velocity, comoving)
        beta = 2.0 * vmax / vc
        v_dep = 1.0 / (1.0 + beta * beta)
        small = 2.0 * vmax * v_dep * v_dep * sigma_co
        large = (3.0 * math.sqrt(3.0) / 16.0) * vc * sigma_co
        bound = torch.where(2.0 * vmax < vc / math.sqrt(3.0), small, large)
    elif cs_type == 3:
        bound = 2.0 * vel_scale * sigma_co
    else:
        raise ValueError(f"unknown CROSS_SECTION_TYPE {cs_type}")
    c = ngb_fac * bound
    if (not per_dt_h0) and comoving:
        from .cosmo import s_of_a
        c = c / s_of_a(time, hubble, omega0, omega_lambda)
    return c
