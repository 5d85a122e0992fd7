"""Global conserved quantities and the reference's log files (port of
``sidm_tpu/diagnostics.py``: ``compute_system_state`` :25, ``EnergyLog``,
``InfoLog``, ``CpuLog``, ``Timer`` and ``TimingsLog`` :60-171).

Per-type mass, kinetic/potential/internal energy, momentum, angular
momentum and centre of mass (nbody/global.c:18-136). The per-type sums are
accumulated in float64 and returned in the state's dtype.

``EnergyLog``/``InfoLog``/``CpuLog``/``TimingsLog`` write the
FdEnergy/FdInfo/FdCPU/FdTimings formats (run.c:230-330, gravtree.c:331-404)
as the JAX package writes them, so the same analysis tools parse both.
"""

from __future__ import annotations

import os
import time as _time
from typing import Optional

import numpy as np
import torch

from .state import Particles, SystemState


def compute_system_state(p: Particles, pot: Optional[torch.Tensor] = None,
                         n_types: int = 6) -> SystemState:
    """Per-type global sums; ``pot`` defaults to ``p.pot``."""
    if pot is None:
        pot = p.pot
    dtype = p.pos.dtype
    t = torch.clamp(p.ptype, 0, n_types - 1).long()
    w = p.valid
    m = torch.where(w, p.mass, torch.zeros_like(p.mass))

    def bytype(x):
        x = torch.where(w.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                        torch.zeros_like(x)).double()
        out = torch.zeros((n_types,) + x.shape[1:], dtype=torch.float64,
                          device=x.device)
        return out.index_add_(0, t, x).to(dtype)

    v2 = torch.sum(p.vel * p.vel, dim=-1)
    eint = torch.where(p.is_gas, m * p.egy_spec, torch.zeros_like(m))
    return SystemState(
        mass_comp=bytype(m),
        energy_kin_comp=bytype(0.5 * m * v2),
        energy_pot_comp=bytype(0.5 * m * pot),
        energy_int_comp=bytype(eint),
        momentum_comp=bytype(m[:, None] * p.vel),
        ang_momentum_comp=bytype(m[:, None] * torch.cross(p.pos, p.vel,
                                                          dim=-1)),
        center_of_mass_comp=bytype(m[:, None] * p.pos),
    )


def system_state_to_host(s: SystemState) -> SystemState:
    """The same state with numpy fields, copied from the device at once."""
    names = ("mass_comp", "energy_kin_comp", "energy_pot_comp",
             "energy_int_comp", "momentum_comp", "ang_momentum_comp",
             "center_of_mass_comp")
    flat = torch.cat([getattr(s, f).reshape(-1) for f in names]).cpu()
    out, i = {}, 0
    for f in names:
        a = getattr(s, f)
        out[f] = flat[i:i + a.numel()].reshape(a.shape).numpy()
        i += a.numel()
    return SystemState(**out)


class _LogFile:
    def __init__(self, path: str, append: bool = False):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = open(path, "a" if append else "w")

    def close(self):
        self.f.close()


class EnergyLog(_LogFile):
    """FdEnergy writer (run.c:295-330 energy_statistics): one line per call
    of 24 ``%g`` columns: time, the total internal, potential and kinetic
    energies, the (internal, potential, kinetic) triple of types 0-4 and
    the masses of types 0-4 (JAX's docstring says 28; its writer writes
    these 24)."""

    def write(self, time: float, sys: SystemState):
        s = sys
        eint = float(np.sum(np.asarray(s.energy_int_comp)))
        epot = float(np.sum(np.asarray(s.energy_pot_comp)))
        ekin = float(np.sum(np.asarray(s.energy_kin_comp)))
        cols = [time, eint, epot, ekin]
        for i in range(5):
            cols += [float(s.energy_int_comp[i]), float(s.energy_pot_comp[i]),
                     float(s.energy_kin_comp[i])]
        cols += [float(s.mass_comp[i]) for i in range(5)]
        self.f.write(" ".join(f"{c:g}" for c in cols) + "\n")
        self.f.flush()


class InfoLog(_LogFile):
    """FdInfo writer (run.c:236-241): step number, time, timestep."""

    def write(self, step: int, time: float, n_active: int, dt: float):
        self.f.write(
            f"\nBegin Step {step}, Time: {time:g}, NumForceUpdate: {n_active}, "
            f"Systemstep: {dt:g}\n")
        self.f.flush()


class CpuLog(_LogFile):
    """FdCPU writer (run.c:250-285): cumulative per-phase wall-clock buckets."""

    BUCKETS = ["Total", "Gravity", "Hydro", "Domain", "Potential", "Predict",
               "TimeLine", "Snapshot", "TreeWalk", "TreeConstruction",
               "CommSum", "Imbalance", "EnsureNgb", "Sidm", "Diagnostic"]

    def __init__(self, path: str, append: bool = False):
        super().__init__(path, append)
        self.cpu = {b: 0.0 for b in self.BUCKETS}

    def add(self, bucket: str, seconds: float):
        self.cpu[bucket] += seconds
        self.cpu["Total"] += seconds if bucket != "Total" else 0.0

    def add_sub(self, bucket: str, seconds: float):
        """Informational sub-bucket (TreeWalk/TreeConstruction/...): the
        time is already counted in a primary bucket, so Total is not
        bumped (mirrors run.c:250-285 where Total is measured, not
        summed)."""
        self.cpu[bucket] += seconds

    def write(self, step: int, time: float, n_tasks: int = 1):
        self.f.write(f"Step {step}, Time: {time:g}, CPUs: {n_tasks}\n")
        self.f.write(" ".join(f"{self.cpu[b]:.2f}" for b in self.BUCKETS) + "\n")
        self.f.flush()


class Timer:
    """Wall-clock phase timer (system.c second()/timediff()) adding to a
    CpuLog bucket; work on the card must be synchronised inside it."""

    def __init__(self, log: Optional[CpuLog], bucket: str):
        self.log, self.bucket = log, bucket

    def __enter__(self):
        self.t0 = _time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.log is not None:
            self.log.add(self.bucket, _time.perf_counter() - self.t0)
        return False


class TimingsLog(_LogFile):
    """FdTimings writer (DIAG, gravtree.c:331-404): per-step tree/force
    statistics — interaction counts per particle and throughput."""

    def write(self, step: int, time: float, n_active: int,
              n_pairs: int = 0, n_segs: int = 0, wall_s: float = 0.0):
        per = (n_pairs + n_segs) / max(n_active, 1)
        rate = n_active / max(wall_s, 1e-9)
        self.f.write(f"Step= {step}  t= {time:g}  Nf= {n_active}\n")
        self.f.write(f"   inter/part: {per:.1f}  (nodes {n_pairs}, "
                     f"segs {n_segs})  part/sec: {rate:.5g}\n")
        self.f.flush()
