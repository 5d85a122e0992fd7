"""Time integration: prediction, DKD advance, reflection, the periodic
wrap (port of ``sidm_tpu/integrate.py:26-150``).

Same drift-kick-drift scheme as the reference's ``advance()``
(nbody/predict.c:245-385), as tensor ops under an ``active`` mask. Each
function returns a new ``Particles``; the input is not modified.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .cosmo import accel_postfactors, drift_factor, old_acc_reference
from .state import Particles


class StepConsts(NamedTuple):
    """Scalars fixed over a run."""

    G: float
    hubble: float
    omega0: float
    omega_lambda: float
    comoving: bool
    periodic: bool
    box_size: float
    no_force: bool
    no_scatter: bool
    reflection_radius: float  # 0 = off
    min_egy_spec: float = 0.0
    min_gas_hsml: float = 0.0


def predict_positions(p: Particles, time, consts: StepConsts):
    """PosPred/VelPred at the global time (predict.c:24-117); the velocity
    prediction uses the previous acceleration."""
    dt = (time - p.current_time)[:, None]
    dt_h0 = dt * drift_factor(time, consts.hubble, consts.omega0,
                              consts.omega_lambda, consts.comoving)
    pos_pred = p.pos + p.vel * dt_h0
    vel_pred = p.vel if consts.no_force else p.vel + p.accel * dt
    return pos_pred, vel_pred


def apply_accel_postfactors(raw_accel, pos_pred, vel_pred, time,
                            consts: StepConsts):
    """Raw summed accelerations -> kick accelerations and the |a| stored
    for the relative opening criterion (gravtree.c:250-324)."""
    fac1, fac2, fac3 = accel_postfactors(
        time, consts.G, consts.hubble, consts.omega0, consts.omega_lambda,
        consts.comoving, consts.periodic)
    if consts.comoving:
        accel = fac1 * raw_accel + fac2 * vel_pred + fac3 * pos_pred
    else:
        accel = fac1 * raw_accel + fac3 * pos_pred
    old_acc = old_acc_reference(accel, pos_pred, time, consts.G,
                                consts.hubble, consts.omega0,
                                consts.comoving, consts.periodic)
    return accel, old_acc


def advance(p: Particles, time, active, consts: StepConsts) -> Particles:
    """DKD leapfrog for active particles (predict.c:245-385)."""
    dt = 2.0 * (time - p.current_time)
    dt = torch.where(active, dt, torch.zeros_like(dt))
    dtc = dt[:, None]
    s_inv = drift_factor(time, consts.hubble, consts.omega0,
                         consts.omega_lambda, consts.comoving)

    pos = p.pos + 0.5 * p.vel * dtc * s_inv
    vel = p.vel if consts.no_force else p.vel + p.accel * dtc
    if not consts.no_scatter:
        vel = vel + torch.where(active[:, None], p.dvel,
                                torch.zeros_like(p.dvel))
    pos = pos + 0.5 * vel * dtc * s_inv

    new_current = torch.where(active, time + 0.5 * dt, p.current_time)
    dvel = torch.where(active[:, None], torch.zeros_like(p.dvel), p.dvel)

    gas_act = active & p.is_gas
    egy = torch.where(gas_act,
                      torch.clamp(p.egy_spec + p.dt_egy * dt,
                                  min=consts.min_egy_spec), p.egy_spec)
    density = torch.where(gas_act, p.density + p.dt_density * 0.5 * dt,
                          p.density)
    hsml = torch.where(gas_act,
                       torch.clamp(p.hsml + p.dt_hsml * dt,
                                   min=consts.min_gas_hsml), p.hsml)
    return dataclasses.replace(p, pos=pos, vel=vel, dvel=dvel,
                               current_time=new_current, egy_spec=egy,
                               density=density, hsml=hsml)


def reflect(p: Particles, radius: float) -> Particles:
    """Spherical reflecting wall (nbody/reflection.c:7-32)."""
    r2 = torch.sum(p.pos * p.pos, dim=-1)
    vr = torch.sum(p.pos * p.vel, dim=-1)
    outside = (r2 > radius * radius) & (vr > 0.0) & p.valid
    r2_safe = torch.clamp(r2, min=1e-30)
    vel = torch.where(outside[:, None],
                      p.vel - 2.0 * (vr / r2_safe)[:, None] * p.pos, p.vel)
    return dataclasses.replace(p, vel=vel)


def box_wrap(p: Particles, box: float) -> Particles:
    """Positions onto [0, box) (predict.c do_box_wrapping:395-416). A
    coordinate just below 0 whose wrap rounds to box itself is set to 0
    (the JAX package leaves it at box)."""
    pos = p.pos - box * torch.floor(p.pos / box)
    return dataclasses.replace(
        p, pos=torch.where(pos >= box, torch.zeros_like(pos), pos))


def find_next_time(p: Particles, big: float = 1e37):
    """Global next time = min over valid particles of max_pred_time."""
    mpt = torch.where(p.valid, p.max_pred_time,
                      torch.full_like(p.max_pred_time, big))
    return torch.min(mpt)


def active_mask(p: Particles, time, tol: float = 0.0):
    """Particles due for a kick at ``time``."""
    return p.valid & (p.max_pred_time <= time + tol)
