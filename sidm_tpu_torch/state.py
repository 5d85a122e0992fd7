"""Particle state as a dataclass of tensors (port of ``sidm_tpu/state.py``).

Same fields, padding and meaning as the JAX ``Particles`` pytree: arrays
have a padded length N; padding slots carry ``ptype == -1`` and
``mass == 0`` so every operation treats them as inert. Particle ids are
int64 here (torch has no uint32 arithmetic); ``state_dict`` hands them back
as uint32, the JAX package's type.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass
class Particles:
    # --- core (all types) ---
    pos: torch.Tensor            # (N,3) comoving position
    vel: torch.Tensor            # (N,3) internal velocity
    mass: torch.Tensor           # (N,)
    ptype: torch.Tensor          # (N,) int32; Gadget type 0..5, -1 = padding
    pid: torch.Tensor            # (N,) int64 particle id
    accel: torch.Tensor          # (N,3) last acceleration (factors applied)
    pot: torch.Tensor            # (N,) gravitational potential
    old_acc: torch.Tensor        # (N,) |a| for the relative opening criterion
    # --- SIDM ---
    dvel: torch.Tensor           # (N,3) pending scattering velocity kick
    hsml_vd: torch.Tensor        # (N,) SIDM/veldisp smoothing length
    ngb_vd: torch.Tensor         # (N,) int32 neighbour count at hsml_vd
    vel_disp: torch.Tensor       # (N,) local velocity dispersion
    dens_vd: torch.Tensor        # (N,) local DM density
    # --- individual timesteps ---
    current_time: torch.Tensor   # (N,) particle proper integration time
    max_pred_time: torch.Tensor  # (N,) time at which the particle is kicked
    # --- SPH ---
    egy_spec: torch.Tensor       # (N,) specific internal energy
    density: torch.Tensor        # (N,)
    hsml: torch.Tensor           # (N,) SPH smoothing length
    dt_egy: torch.Tensor         # (N,) du/dt
    dt_density: torch.Tensor     # (N,) drho/dt
    dt_hsml: torch.Tensor        # (N,) dh/dt
    div_vel: torch.Tensor        # (N,)
    curl_vel: torch.Tensor       # (N,)
    ngb_sph: torch.Tensor        # (N,) int32

    @property
    def n_padded(self) -> int:
        return self.pos.shape[0]

    @property
    def valid(self) -> torch.Tensor:
        return self.ptype >= 0

    @property
    def is_gas(self) -> torch.Tensor:
        return self.ptype == 0

    @property
    def is_collisionless(self) -> torch.Tensor:
        return self.ptype > 0

    def count_valid(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32))


def make_particles(pos, vel, mass, ptype, pid=None, *, egy_spec=None,
                   pad_to_multiple: int = 256,
                   n_padded: Optional[int] = None,
                   dtype=torch.float32, device=None) -> Particles:
    """Build padded Particles from host arrays (``sidm_tpu/state.py:93``):
    values are padded in float64 on the host and rounded once to ``dtype``."""
    pos = np.asarray(pos, dtype=np.float64)
    n = pos.shape[0]
    if n_padded is None:
        n_padded = _round_up(max(n, 1), pad_to_multiple)
    if n_padded < n:
        raise ValueError(f"n_padded={n_padded} < n={n}")

    def dev(a, dt):
        return torch.as_tensor(a).to(device=device, dtype=dt)

    def pad2(a):
        out = np.zeros((n_padded, 3), np.float64)
        out[:n] = np.asarray(a, np.float64)
        return dev(out, dtype)

    def pad1(a, fill, np_dt, dt):
        out = np.full((n_padded,), fill, dtype=np_dt)
        out[:n] = np.asarray(a)
        return dev(out, dt)

    if pid is None:
        pid = np.arange(1, n + 1, dtype=np.int64)
    ptype_arr = np.full((n_padded,), -1, dtype=np.int32)
    ptype_arr[:n] = np.asarray(ptype, dtype=np.int32)

    def zeros1():
        return torch.zeros(n_padded, dtype=dtype, device=device)

    def zeros3():
        return torch.zeros(n_padded, 3, dtype=dtype, device=device)

    def izeros():
        return torch.zeros(n_padded, dtype=torch.int32, device=device)

    return Particles(
        pos=pad2(pos), vel=pad2(vel),
        mass=pad1(mass, 0.0, np.float64, dtype),
        ptype=dev(ptype_arr, torch.int32),
        pid=pad1(np.asarray(pid, np.int64), 0, np.int64, torch.int64),
        accel=zeros3(), pot=zeros1(), old_acc=zeros1(), dvel=zeros3(),
        hsml_vd=zeros1(), ngb_vd=izeros(), vel_disp=zeros1(),
        dens_vd=zeros1(), current_time=zeros1(), max_pred_time=zeros1(),
        egy_spec=(pad1(egy_spec, 0.0, np.float64, dtype)
                  if egy_spec is not None else zeros1()),
        density=zeros1(), hsml=zeros1(), dt_egy=zeros1(),
        dt_density=zeros1(), dt_hsml=zeros1(), div_vel=zeros1(),
        curl_vel=zeros1(), ngb_sph=izeros())


def state_dict(p: Particles) -> dict:
    """All fields as numpy arrays, in the JAX package's dtypes (pid uint32;
    JAX ``state.py:207``, what a restart file holds):
    ``sidm_tpu.state.state_from_dict`` rebuilds the JAX state from the
    result."""
    out = {}
    for f in dataclasses.fields(p):
        a = getattr(p, f.name).detach().cpu().numpy()
        out[f.name] = a.astype(np.uint32) if f.name == "pid" else a
    return out


def state_from_dict(d: dict, device=None) -> Particles:
    """Particles from a dict of numpy arrays (JAX ``state.py:212``; e.g.
    JAX's ``state_dict`` of its ``Particles``), on ``device``."""
    kw = {}
    for f in dataclasses.fields(Particles):
        a = np.asarray(d[f.name])
        if f.name == "pid":
            a = a.astype(np.int64)
        kw[f.name] = torch.as_tensor(a).to(device)
    return Particles(**kw)


@dataclass
class SystemState:
    """Global conserved-quantity summary per type (allvars.h:517-537)."""

    mass_comp: torch.Tensor          # (6,)
    energy_kin_comp: torch.Tensor    # (6,)
    energy_pot_comp: torch.Tensor    # (6,)
    energy_int_comp: torch.Tensor    # (6,)
    momentum_comp: torch.Tensor      # (6,3)
    ang_momentum_comp: torch.Tensor  # (6,3)
    center_of_mass_comp: torch.Tensor  # (6,3)

    @property
    def energy_tot_comp(self):
        return (self.energy_kin_comp + self.energy_pot_comp
                + self.energy_int_comp)

    @property
    def mass(self):
        return torch.sum(self.mass_comp)

    @property
    def energy_kin(self):
        return torch.sum(self.energy_kin_comp)

    @property
    def energy_pot(self):
        return torch.sum(self.energy_pot_comp)

    @property
    def energy_int(self):
        return torch.sum(self.energy_int_comp)

    @property
    def energy_tot(self):
        return torch.sum(self.energy_tot_comp)
