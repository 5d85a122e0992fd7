"""The Simulation object (port of ``sidm_tpu/simulation.py``:
``softening_table`` :44, ``Simulation.__init__``/setup :59-196 with
``root_key`` :74, the phased step ``step_phased`` :839-1283 with
``_force_core`` :556-641, ``_sidm_params_for_phased`` :748,
``_refit_list_caps`` :774-806, ``_SIDM_K_CEILING`` and
``_refit_sidm_caps`` :815-836 and ``phase_finish`` :726-741, ``prepare``
:1285 with the SIDM smoothing-length init :1296-1312, the run loop ``run``
:1421 with ``load_ic`` :113, ``_open_logs`` :1411,
``_write_scatter_log`` :1387, ``write_snapshot_file`` :1524,
``compute_potential`` :1550, ``energy_statistics`` :1576 and
``write_restart_file``/``load_restart_file`` :1591-1615; the
single-program step ``_build_step`` :373-458 with ``_make_force_fn``
:271-300, its prepare :1318-1322 and the choice of step ``_use_phased``
:1344-1350; the velocity-dispersion pass :401-404 and ``phase_veldisp``
:665-673, :1009-1011; periodic boxes and comoving runs: ``check_omega``
:147-160, ``_ewald_table`` :198-207, ``_use_treepm`` :209-214,
``_pm_kernel`` :254-270, the periodic direct sum and TreePM of
``_make_force_fn`` :276-283, :303-331 and of the phased step :481-526,
``box_wrap`` in both finishes :439-443, :730-731, and ``compute_potential``'s
comoving and periodic terms :1550-1575).

A periodic box (``PeriodicBoundariesOn 1``) runs TreePM on ``ForceMethod
tree`` (``PMGrid`` >= 0, 0 choosing the mesh by N): the walk's periodic
mode gives the short range (the minimum image, the screened pair force cut
at ``rcut``, ``ops/wq_force.py``) and ``ops/pm.py``'s mesh the long range;
``ForceMethod direct`` is the minimum-image direct sum with the Ewald
correction (``ops/ewald.py``). Positions are wrapped onto the box after
every step. Comoving runs (``ComovingIntegrationOn 1``) take the scale
factor as their time (in the logs, snapshots and restarts), the comoving
drift and kick factors and timestep criteria, the softenings of the current
scale factor every step (``softening_table``: comoving, capped by
``MaxPhys`` in physical units), and ``check_omega`` at prepare in a
periodic box; on the lists they keep the moments refresh between rebuilds
instead of the node drift.

``mode="individual"`` (JAX's ``sync = False``, :378, :471) keeps every
particle's own next kick time: a step advances only the particles due at
the earliest of them (``max_pred_time`` equal to it) and leaves the others
as they were. The other modes give every particle the global minimum
timestep after each step (synchronized steps). ``individual`` picks its
step by N as ``synchronized`` does.

Below PHASE_THRESHOLD padded particles (``mode="synchronized"``) and at
any N (``mode="fused"``) a step is the JAX package's single-program step:
predict, the force (the wq walk on a fresh tree, ``ForceMethod tree``, or
the direct sum, ``direct``), the kick factors, the hash-grid DSMC pass
(``ops/sidm.py`` ``sidm_scatter``, its rows per bucket grown to the
step's demand where JAX drops the rest), the velocity-dispersion pass
(``VelDispOn 1``, ``ops/veldisp.py``; its rows per bucket and grid levels
grown to the demand likewise), then the finish below;
``prepare`` sets the smoothing lengths by ``setup_smoothing_lengths``. A
walk that drops cells on that step's tree (JAX's depth 10 below 2^18
particles) is redone at depth 13 for the rest of the run.

Otherwise one step is the JAX package's phased step for a non-periodic
tree run on the work-queue walk (``TreeWalkEngine wq``), in one of two
cadences:

* ``ListMode 1`` (cached interaction lists, the flagship's): on a rebuild
  step the octree is built and the interaction lists recorded under a skin
  sized from the observed displacement rate, the last dt and
  ``TreeRefreshSteps``; on the other steps the rebuild-time tree is
  advanced by the node drift velocities and the cached lists evaluated. A
  step whose particles moved more than skin/2 since the record (the
  validity monitor) ends the cycle. A record that drops any entry is
  recomputed with the walk, the caps are refit from the recorded demand,
  and after three refits the walk takes over for good.
* ``ListMode 0``: every step walks the tree, rebuilt every
  ``TreeRefreshSteps``-th force (or early once the refresh drift exceeds a
  quarter of the deepest cell) and moments-only refreshed otherwise.

With ``SIDMOn 1`` the DSMC pass follows the force. On the list cadence: on
every rebuild step (and after a mid-cycle invalidation) the smoothing
lengths are clamped to 2.5x a cell-count density bound and the candidate
lists are recorded under the force skin (up to 4 attempts with a cap refit
in between; K truncation at the ceiling is accepted and its dropped share
kept in ``sidm_trunc_frac``), the tail capacity is fitted; then every step
runs ``sidm_scatter_lists`` on the cached lists, re-records next step once
the particles moved more than half the candidate skin, and grows the gated
and tail capacities after a drop. With ``ListMode 0``, once the candidate
cap refit is exhausted (from that step on), and once the force lists are
given up, the step runs the DSMC pass on the range walk instead
(``sidm_scatter_wq``, JAX ``simulation.py:1128-1134, 1242-1250``); its
drops are reported in ``last_sidm_info`` and on stderr. ``prepare`` sets
the initial smoothing lengths by ``tree_hsml_init_fused``.

With ``VelDispOn 1`` the velocity-dispersion pass follows the force on
both steps (JAX runs it right after the force phase).

Then: kick factors -> DKD advance (which applies the scattering kicks) ->
reflection -> new timesteps (the global minimum unless
``mode="individual"``). Tensors live on the device given at construction
and are never moved; with no device given it is the CUDA card, and
without one the constructor raises.

``run`` is the main loop of run.c with the JAX package's cadences: energy
statistics every ``TimeBetStatistics``, snapshots from
``TimeOfFirstSnapshot`` every ``TimeBetSnapshot`` (or at
``OutputListTimes``), the info, CPU and timings logs every step, the
scatter log (``ScatterLog 1``: ``sct_XXX.0``, the first
``SidmParams.event_cap`` events of each step; the rest are counted in
``last_sidm_info["events_dropped"]``), restarts every
``CpuTimeBetRestartFile`` and at the end, and the stops of a ``stop``
file and of 85 % of ``TimeLimitCPU``. A resumed run (``restart_flag
1``) re-reads the whole parameter file, as JAX does.

Configurations outside the port raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time as _wallclock
from typing import Optional

import numpy as np
import torch

from . import integrate, timestep
from .config import ParameterError, SimConfig, Units, \
    parse_parameter_file, set_units, write_parameters_out
from .constants import MAX_REAL_NUMBER
from .diagnostics import (CpuLog, EnergyLog, InfoLog, Timer, TimingsLog,
                          compute_system_state, system_state_to_host)
from .integrate import StepConsts
from .io import checkpoint as ckpt
from .io.gadget import GadgetHeader, Snapshot, read_snapshot, write_snapshot
from .ops.direct import direct_sum
from .ops.ewald import PSI0, build_ewald_table
from .ops.fused_force import default_depth
from .ops.fused_range import cell_count_hsml_seed, tree_hsml_init_fused
from .ops.list_force import (ListConfig, advance_tree, eval_lists,
                             max_displacement, record_lists)
from .ops.list_range import (RangeListConfig,
                             record_candidates_from_particles,
                             sidm_scatter_lists)
from .ops.neighbors import setup_smoothing_lengths
from .ops.pm import build_pm_kernel, pm_accel
from .ops.sidm import SidmParams, make_sidm_step, sidm_params
from .ops.tree import build_octree, refresh_octree
from .ops.veldisp import veldisp
from .ops.wq_force import wq_gravity, wq_gravity_tree
from .ops.wq_range import sidm_scatter_wq
from .rng import run_key, step_key
from .state import Particles, make_particles


def softening_table(cfg: SimConfig, a: float) -> np.ndarray:
    """Comoving softening per type, clamped by MaxPhys (gravtree.c:431-459)."""
    com = np.array([cfg.SofteningGas, cfg.SofteningHalo, cfg.SofteningDisk,
                    cfg.SofteningBulge, cfg.SofteningStars, 0.0])
    phys = np.array([cfg.SofteningGasMaxPhys, cfg.SofteningHaloMaxPhys,
                     cfg.SofteningDiskMaxPhys, cfg.SofteningBulgeMaxPhys,
                     cfg.SofteningStarsMaxPhys, 0.0])
    if cfg.ComovingIntegrationOn:
        table = np.where(com * a > phys, phys / max(a, 1e-30), com)
    else:
        table = com
    return np.maximum(table, 1e-30)


def _refuse(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to sidm_tpu_torch yet (ROADMAP.md {item})")


MODES = ("synchronized", "phased", "fused", "individual")
VD_LEVELS = 10      # the velocity-dispersion grid's levels, JAX's
MAX_VD_LEVELS = 24


def check_supported(cfg: SimConfig, mode: str, device: torch.device):
    """Raise NotImplementedError for anything outside the ported slice,
    ValueError for an unknown mode and for scattering SIDM with
    VelDispOn."""
    if cfg.ForceMethod not in ("tree", "direct"):
        _refuse(f"ForceMethod {cfg.ForceMethod}", "A, item 15")
    if cfg.ForceMethod == "direct" and mode == "phased":
        _refuse_phased_direct()
    if cfg.TreeWalkEngine != "wq":
        _refuse(f"TreeWalkEngine {cfg.TreeWalkEngine}", "A, item 15")
    if cfg.PMVacuum and not cfg.PeriodicBoundariesOn \
            and cfg.ForceMethod == "tree":
        _refuse("PMVacuum (the free-space TreePM mesh)", "A, item 11.2")
    if cfg.PeriodicBoundariesOn:
        if cfg.ForceMethod == "tree" and cfg.PMGrid < 0:
            _refuse("PMGrid -1 (the per-pair Ewald walk)", "A, item 11.3")
        if mode == "phased" and cfg.ForceMethod == "tree" and cfg.ListMode:
            _refuse_periodic_lists()
        if cfg.SIDMOn and cfg.CrossSection > 0:
            _refuse("DSMC (SIDMOn) in a periodic box", "A, item 11.4")
        if cfg.VelDispOn:
            _refuse("VelDispOn in a periodic box", "A, item 11.4")
    if cfg.ComovingIntegrationOn and (
            (cfg.SIDMOn and cfg.CrossSection > 0) or cfg.VelDispOn):
        _refuse("DSMC (SIDMOn) and VelDispOn in comoving runs",
                "A, item 11.4")
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: not one of {MODES}")
    if cfg.SIDMOn and cfg.CrossSection > 0 and cfg.VelDispOn:
        # the parameter file's rule (config.py) for configurations built in
        # code, where SIDMOn with CrossSection 0 (the default) scatters
        # nothing
        raise ParameterError("VELDISP cannot be used with SIDM "
                             "(sidm.c:14-16)")
    if cfg.Precision == "f64" and device.type == "cuda":
        _refuse("Precision f64 on CUDA (the kernels are float32)",
                "A, item 16")


def _refuse_periodic_lists():
    # JAX's list engine takes pbc (list_force.py:162-189, :631-636)
    _refuse("ListMode 1 (the cached interaction lists) with a periodic box "
            "on the phased step", "A, item 11.1")


def _refuse_phased_direct():
    # JAX's phased step runs ForceMethod direct through treeforce and
    # sidm_scatter_tree, which are out of the port's scope
    _refuse("ForceMethod direct on the phased step (mode='phased', or "
            "N >= Simulation.PHASE_THRESHOLD with mode='synchronized')",
            "A, item 15")


class _PhaseClock:
    """Per-phase wall time: CUDA events on the card, the host clock on the
    CPU. ``mark(label)`` closes the phase that started at the previous mark;
    ``seconds()`` synchronises once and returns {label: seconds}."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = [(None, self._now())]

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return _wallclock.perf_counter()

    def mark(self, label: str):
        self.marks.append((label, self._now()))

    def seconds(self) -> dict:
        if self.cuda:
            self.marks[-1][1].synchronize()
        out = {}
        for (_, a), (label, b) in zip(self.marks, self.marks[1:]):
            dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            out[label] = out.get(label, 0.0) + dt
        return out


def resolve_device(device=None) -> torch.device:
    """The device a Simulation runs on: the one asked for, else the CUDA
    card. Without a card the caller has to ask for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


class Simulation:
    PHASE_THRESHOLD = 262144
    LIST_REFITS = 3     # cap refits before the walk takes over for good
    SIDM_REFITS = 3     # candidate-cap refits before the lists are given up
    # ceiling of the per-particle candidate storage (n K 4 bytes): demand
    # above it comes from rare targets whose h is far out of the neighbour
    # band; their lists truncate at K until their controllers shrink h
    SIDM_K_CEILING = 384
    # the hash engine (single-program step): grow its rows per bucket to
    # the step's demand (JAX keeps 96 and drops the rest: ROADMAP C.13);
    # False keeps the JAX package's drops, for the parity tests
    HASH_CAP_GROWTH = True
    HASH_TRIES = 4
    # the single-program step's walk: an overflowing tree of
    # default_depth's is built again at this depth (JAX's above 2^18)
    DEEP_DEPTH = 13

    def __init__(self, cfg: SimConfig, restart_flag: int = 0,
                 mode: str = "synchronized", device=None):
        check_supported(cfg, mode, torch.device(device if device is not None
                                                else "cuda"))
        self.device = resolve_device(device)
        self.cfg = cfg
        self.units: Units = set_units(cfg)
        self.mode = mode
        self.restart_flag = restart_flag
        self.particles: Optional[Particles] = None
        self.time = cfg.TimeBegin
        self.step_count = 0
        self.snapshot_count = 0
        self.time_last_statistics = cfg.TimeBegin - cfg.TimeBetStatistics
        self.time_of_first_snapshot = cfg.TimeOfFirstSnapshot
        self.cpu_this_run = 0.0
        self.time_last_restart = 0.0
        self._logs_open = False
        self.vmax = 0.0
        self.sys_state_at_start = None
        self.last_phase_wall = {}
        self.last_walk_info = None
        self.dtype = torch.float64 if cfg.Precision == "f64" \
            else torch.float32
        self.consts = StepConsts(
            G=self.units.G, hubble=self.units.Hubble, omega0=cfg.Omega0,
            omega_lambda=cfg.OmegaLambda,
            comoving=bool(cfg.ComovingIntegrationOn),
            periodic=bool(cfg.PeriodicBoundariesOn), box_size=cfg.BoxSize,
            no_force=bool(cfg.NoForce), no_scatter=bool(cfg.NoScatter),
            reflection_radius=cfg.ReflectionBoundary,
            min_egy_spec=self.units.MinEgySpec,
            min_gas_hsml=cfg.MinGasHsmlFractional * cfg.SofteningGas)
        self.last_step_rebuilt = False
        self.last_list_info = None
        self._uniform_eps = None
        # no level cap: a level drops entries only where its group's list
        # overflows (ROADMAP C.8)
        self._lfc = ListConfig(far_cap=int(cfg.ListFarCap),
                               near_cap=int(cfg.ListNearCap))
        self._list_refits = 0
        self._diag_far = self._diag_near = 0
        self.root_key = run_key(cfg.RandomSeed1, cfg.RandomSeed2)
        self._sidm_rcfg: Optional[RangeListConfig] = None
        self._sidm_refits = 0
        self._sidm_tail_pending = 0
        self._sidm_k_warned = False
        self._walk_seg_cap = 8192   # the walk engine's segment lists and
        self._walk_fcfg = None      # caps, grown to its demand
        self.sidm_trunc_frac = 0.0
        self.sidm_trunc_targets = 0
        self.last_sidm_info = None
        self.last_hsml_init = None
        self._hash_cap = SidmParams._field_defaults["cap"]   # JAX's 96
        self._vd_levels = VD_LEVELS
        self.last_veldisp_info = None
        self._small_depth = None
        self._hash_step = None
        self._ewald = None
        self._pm = None
        self._reset_cadence()

    def _reset_cadence(self):
        """The rebuild/list cadence state, as the JAX package sets it up
        whenever it (re)builds its phase functions: at the first step and
        after every cap refit."""
        self._tree_cache = None
        self._lists_cache = None
        self._refresh_left = 0
        self._disp_rate = 0.0
        self._skin_now = 0.0
        self._last_dt = 0.0
        self._t_rebuild = float(self.time)
        self._lists_disabled = False
        self._cadence_stale = False
        self._steps_since_build = 0
        self._sidm_cands = None
        self._sidm_lists_disabled = False

    # ------------------------------------------------------------------ setup

    @classmethod
    def from_parameter_file(cls, path: str, restart_flag: int = 0, **kw):
        cfg = parse_parameter_file(path)
        sim = cls(cfg, restart_flag=restart_flag, **kw)
        write_parameters_out(cfg)
        return sim

    def set_particles_from_arrays(self, pos, vel, mass, ptype, pid=None,
                                  pad_to_multiple: int = 256):
        if np.any(np.asarray(ptype) == 0):
            _refuse("gas particles (SPH)", "A, item 12")
        p = make_particles(pos, vel, mass, ptype, pid=pid,
                           pad_to_multiple=pad_to_multiple, dtype=self.dtype,
                           device=self.device)
        self.particles = self._init_particle_times(p)

    def load_ic(self, path: Optional[str] = None):
        """read_ic (nbody/read_ic.c): a Gadget snapshot (``ICFormat 1``) or
        ZIC cluster ICs (``ICFormat 3``, not on restart flag 2) as initial
        conditions, the path ``InitCondFile`` beside ``OutputDir`` as JAX
        joins it. Restart flag 2 takes the time from the snapshot header
        (read_ic.c:118-121). Gas is refused."""
        path = path or os.path.join(os.path.dirname(self.cfg.OutputDir),
                                    self.cfg.InitCondFile)
        if self.cfg.ICFormat == 3 and self.restart_flag != 2:
            from .io.zic import read_ic_cluster
            zic = read_ic_cluster(path, self.units.G)
            self.set_particles_from_arrays(zic.pos, zic.vel, zic.mass,
                                           zic.ptype, pid=zic.pid)
            return
        snap = read_snapshot(path)
        if self.restart_flag == 2:
            self.time = float(snap.header.time)
        self.set_particles_from_arrays(snap.pos, snap.vel, snap.mass,
                                       snap.ptype, pid=snap.pid)

    def check_omega(self):
        """init.c:201-225: the box's mass must account for Omega0 (comoving
        periodic runs); raises ValueError when |Omega - Omega0| > 1e-3."""
        cfg, u = self.cfg, self.units
        p = self.particles
        masstot = float(torch.sum(torch.where(p.valid, p.mass,
                                              torch.zeros_like(p.mass))))
        rho_crit = 3.0 * u.Hubble * u.Hubble / (8.0 * np.pi * u.G)
        omega = masstot / cfg.BoxSize ** 3 / rho_crit
        if abs(omega - cfg.Omega0) > 1.0e-3:
            raise ValueError(
                f"check_omega: the IC mass content accounts for "
                f"Omega={omega:g}, but the parameter file specifies "
                f"Omega0={cfg.Omega0:g}")

    def _ewald_table(self):
        """The Ewald correction tables of the periodic direct sum
        (ewald_init, ewald.c:35-127), cached in OutputDir."""
        if self._ewald is None:
            self._ewald = build_ewald_table(
                self.cfg.BoxSize, en=self.cfg.EwaldGridSize,
                cache_dir=self.cfg.OutputDir or ".", device=self.device)
        return self._ewald

    def _use_treepm(self) -> bool:
        """Periodic tree runs take the TreePM split (PMGrid >= 0)."""
        return bool(self.cfg.PeriodicBoundariesOn
                    and self.cfg.ForceMethod == "tree")

    def _pm_kernel(self):
        """The TreePM mesh operator (cached): PMGrid cells a side, or with
        PMGrid 0 the power of two from 64 up to 512 that reaches 2 N^(1/3)
        (N padded)."""
        if self._pm is None:
            cfg = self.cfg
            n_mesh = int(cfg.PMGrid)
            if n_mesh == 0:
                npart = (self.particles.pos.shape[0]
                         if self.particles is not None else 1 << 20)
                n_mesh = 64
                while n_mesh < 2.0 * npart ** (1.0 / 3.0) and n_mesh < 512:
                    n_mesh *= 2
            self._pm = build_pm_kernel(
                float(cfg.BoxSize), n=n_mesh, asmth=float(cfg.PMAsmth),
                rcut_fac=float(cfg.PMRcutFac),
                interlace=bool(cfg.PMInterlace), device=self.device)
        return self._pm

    def _pbc(self):
        """(box, alpha, rcut) of the TreePM split, or None."""
        if not self._use_treepm():
            return None
        kern = self._pm_kernel()
        return (float(self.cfg.BoxSize), kern.alpha, kern.rcut)

    def _box(self) -> float:
        return float(self.cfg.BoxSize) if self.cfg.PeriodicBoundariesOn \
            else 0.0

    def _init_particle_times(self, p: Particles) -> Particles:
        t0 = torch.full_like(p.current_time, self.time)
        return dataclasses.replace(p, current_time=t0,
                                   max_pred_time=t0.clone())

    def _timestep_params(self) -> timestep.TimestepParams:
        cfg, u = self.cfg, self.units
        return timestep.TimestepParams(
            criterion=cfg.TypeOfTimestepCriterion,
            err_tol_int_accuracy=cfg.ErrTolIntAccuracy,
            err_tol_vel_scale=cfg.ErrTolVelScale,
            err_tol_dynamical_accuracy=cfg.ErrTolDynamicalAccuracy,
            max_size_timestep=cfg.MaxSizeTimestep,
            min_size_timestep=cfg.MinSizeTimestep,
            courant_fac=cfg.CourantFac,
            art_bulk_visc=cfg.ArtBulkViscConst,
            softening_table=self._softening(),
            sidm_on=bool(cfg.SIDMOn and cfg.CrossSection > 0),
            probability_tol=cfg.ProbabilityTol,
            des_num_ngb=cfg.DesNumNgb,
            max_num_ngb_dev=cfg.MaxNumNgbDeviation,
            cross_section_internal=u.CrossSectionInternal,
            cross_section_type=cfg.CrossSectionType,
            yukawa_velocity=cfg.YukawaVelocity,
            cross_section_vel_scale=cfg.CrossSectionVelScale,
            cross_section_pow_law=cfg.CrossSectionPowLaw,
            G=u.G, hubble=u.Hubble, omega0=cfg.Omega0,
            omega_lambda=cfg.OmegaLambda,
            comoving=bool(cfg.ComovingIntegrationOn))

    def _softening(self) -> torch.Tensor:
        return torch.as_tensor(softening_table(self.cfg, self.time),
                               dtype=self.dtype, device=self.device)

    def _use_phased(self) -> bool:
        """The JAX package's choice of step (simulation.py:1344-1350):
        ``mode="phased"`` the phased step, ``"fused"`` the single-program
        step at any N, ``"synchronized"`` and ``"individual"`` the phased
        step from PHASE_THRESHOLD particles (padded) on."""
        if self.mode == "phased":
            phased = True
        elif self.mode == "fused":
            phased = False
        else:
            phased = self.particles.n_padded >= self.PHASE_THRESHOLD
        if phased and self.cfg.ForceMethod == "direct":
            _refuse_phased_direct()
        return phased

    def _check_uniform_eps(self) -> bool:
        """One softening value across the particle types present: node
        eps_max is then a broadcast (simulation.py:539-554)."""
        cfg = self.cfg
        present = set(torch.unique(self.particles.ptype).tolist())
        com = [cfg.SofteningGas, cfg.SofteningHalo, cfg.SofteningDisk,
               cfg.SofteningBulge, cfg.SofteningStars, 0.0]
        phys = [cfg.SofteningGasMaxPhys, cfg.SofteningHaloMaxPhys,
                cfg.SofteningDiskMaxPhys, cfg.SofteningBulgeMaxPhys,
                cfg.SofteningStarsMaxPhys, 0.0]
        return len({(float(com[t]), float(phys[t])) for t in present}) == 1

    # ------------------------------------------------------------------- step

    def step(self, first: bool = False):
        """One step to the earliest next kick time; returns (dt, n_active,
        n_scatter): the step's size, its active particles (all of them
        unless ``mode="individual"``) and its scatters."""
        if self.particles is None:
            raise RuntimeError("load particles first")
        if self._use_phased():
            return self._step_phased(first)
        return self._step_single(first)

    def _step_single(self, first: bool):
        """The single-program step (``_build_step``, simulation.py:373-458):
        predict; the force (the wq walk, ``ForceMethod tree``, or the
        direct sum, ``direct``); the kick factors; the velocity-dispersion
        pass (``VelDispOn 1``); the hash engine's DSMC pass (``SIDMOn 1``);
        advance, reflection and the timesteps."""
        cfg, consts = self.cfg, self.consts
        params = self._timestep_params()
        clock = _PhaseClock(self.device)
        p = self.particles
        vmax = torch.tensor(self.vmax, dtype=self.dtype, device=self.device)
        t_next = torch.clamp(integrate.find_next_time(p), max=cfg.TimeMax)
        active = integrate.active_mask(p, t_next)
        pos_pred, vel_pred = integrate.predict_positions(p, t_next, consts)
        raw_acc, pot, info = self._force(p, pos_pred,
                                         params.softening_table, False)
        accel, old_acc = integrate.apply_accel_postfactors(
            raw_acc, pos_pred, vel_pred, t_next, consts)
        p = dataclasses.replace(
            p, accel=torch.where(active[:, None], accel, p.accel),
            old_acc=torch.where(active, old_acc, p.old_acc),
            pot=torch.where(active, pot, p.pot))
        self.last_step_rebuilt = True
        self.last_walk_info = info
        self.last_list_info = None
        clock.mark("force")
        p = self._veldisp(p, pos_pred, vel_pred, active, clock)
        n_scat = 0
        self.last_sidm_info = None
        if cfg.SIDMOn and cfg.CrossSection > 0:
            key = step_key(self.root_key,
                           0x7FFFFFFF if first else self.step_count)
            p, n_scat = self._sidm_hash(p, pos_pred, t_next, active, vmax,
                                        key)
            clock.mark("sidm")
        return self._finish(p, t_next, active, vmax, params, first, clock,
                            n_scat)

    def _force(self, p, pos_pred, soft, need_pot: bool):
        """The single-program step's force (``_make_force_fn``,
        simulation.py:271-300): raw (acc, pot, walk info or None). The
        direct sum always gives the potential (JAX's does); the walk only
        with ``need_pot``."""
        cfg = self.cfg
        eps = soft[torch.clamp(p.ptype, 0, 5).long()]
        mass = torch.where(p.valid, p.mass, torch.zeros_like(p.mass))
        if cfg.ForceMethod == "direct":
            box = self._box()
            acc, pot = direct_sum(pos_pred, mass, eps, box=box or None,
                                  ewald=self._ewald_table() if box else None)
            return acc, pot, None
        pbc = self._pbc()
        while True:
            depth = self._small_depth or default_depth(p.n_padded)
            acc, pot, info = wq_gravity(
                pos_pred, mass, eps, p.old_acc, theta=cfg.ErrTolTheta,
                opening=cfg.TypeOfOpeningCriterion,
                err_tol_force_acc=cfg.ErrTolForceAcc, depth=depth,
                need_pot=need_pot, return_info=True, pbc=pbc)
            drops = [int(x) for x in torch.stack([
                info[k] for k in ("ovf_open", "ovf_big",
                                  "ovf_items")]).tolist()]
            if not sum(drops) or depth >= self.DEEP_DEPTH:
                if pbc is not None:
                    acc, pot = self._add_mesh(acc, pot, pos_pred, mass,
                                              p.valid, need_pot)
                return acc, pot, info
            # the walk dropped cells (JAX's walk drops them silently,
            # ROADMAP C.15): the force again on JAX's large-N tree depth,
            # kept for the run
            self._small_depth = self.DEEP_DEPTH
            print(f"WARNING: the walk at tree depth {depth} dropped cells "
                  f"(opened, big, items) {drops}: the force again at depth "
                  f"{self.DEEP_DEPTH}, kept for the run.", file=sys.stderr,
                  flush=True)

    def _add_mesh(self, acc, pot, pos_pred, mass, valid, need_pot: bool):
        """TreePM: the mesh's long range added to the walk's short range;
        the potential (need_pot) also gets psi(0) = 2.8372975/box, loses
        the mesh's self term (JAX simulation.py:318-328) and gets the mean
        of the short-range kernel, pi M / (alpha^2 V): the screened pair
        potential -erfc(alpha r)/r integrates to -pi/alpha^2 over the box,
        which the Ewald potential's convention (ewald_psi's pi/alpha^2,
        ewald.c:291-327) cancels and the mesh's k = 0 mode does not. JAX
        leaves it out (ROADMAP C.18): its TreePM potentials sit that far
        below the Ewald sum's, 1.0 at cosmo-box's N = 8192 and mesh 32."""
        kern = self._pm_kernel()
        acc_l, pot_l = pm_accel(kern, pos_pred, mass,
                                with_potential=need_pot)
        acc = acc + acc_l
        if need_pot:
            box = float(self.cfg.BoxSize)
            mean = np.pi * torch.sum(mass) / (kern.alpha ** 2 * box ** 3)
            pot = pot + pot_l + mass * (PSI0 / box - kern.pot_self) + mean
            pot = torch.where(valid, pot, torch.zeros_like(pot))
        return acc, pot

    def _step_phased(self, first: bool):
        """The phased step (see the module docstring)."""
        cfg, consts = self.cfg, self.consts
        if self._uniform_eps is None:
            self._uniform_eps = self._check_uniform_eps()
        if cfg.PeriodicBoundariesOn and cfg.ListMode:
            _refuse_periodic_lists()
        params = self._timestep_params()
        clock = _PhaseClock(self.device)
        p = self.particles
        vmax = torch.tensor(self.vmax, dtype=self.dtype, device=self.device)

        # force phase (simulation.py:556-641, cadence :885-1006)
        if self._cadence_stale:
            self._reset_cadence()
        refresh_steps = max(int(cfg.TreeRefreshSteps), 1)
        use_lists = bool(cfg.ListMode) and not self._lists_disabled
        t_next = torch.clamp(integrate.find_next_time(p), max=cfg.TimeMax)
        active = integrate.active_mask(p, t_next)
        pos_pred, vel_pred = integrate.predict_positions(p, t_next, consts)
        eps = params.softening_table[torch.clamp(p.ptype, 0, 5).long()]
        mass = torch.where(p.valid, p.mass, torch.zeros_like(p.mass))
        reuse = (not first and self._refresh_left > 0
                 and self._tree_cache is not None
                 and (not use_lists or self._lists_cache is not None))
        info, kind, md = None, "walk", None
        ovf = need = None
        box = self._box()
        drift_mode = use_lists and not cfg.ComovingIntegrationOn
        if reuse and use_lists:
            # cached lists on the advanced rebuild-time tree (comoving runs:
            # on a moments refresh, JAX simulation.py:520-526)
            lists = self._lists_cache
            if drift_mode:
                tree = advance_tree(self._tree_cache, lists, pos_pred,
                                    t_next)
            else:
                tree = refresh_octree(self._tree_cache, pos_pred, mass, eps,
                                      p.valid)
            raw_acc, pot = eval_lists(tree, lists, mass, eps,
                                      need_pot=False)
            kind = "list"
            self._refresh_left -= 1
            self._steps_since_build += 1
            md = float(max_displacement(lists, tree.pos_s))
            # displacement rate per unit simulation time
            t_elapsed = float(t_next) - self._t_rebuild
            if t_elapsed > 0:
                self._disp_rate = max(md / t_elapsed, 0.7 * self._disp_rate)
            # validity monitor: acceptances hold while md <= skin/2
            if md > 0.5 * self._skin_now:
                self._refresh_left = 0
        elif reuse:
            tree = refresh_octree(self._tree_cache, pos_pred, mass, eps,
                                  p.valid, box=box)
            self._refresh_left -= 1
            raw_acc, pot, info = self._walk(tree, mass, eps, p.old_acc)
        else:
            self._tree_cache = self._lists_cache = None
            tree = build_octree(pos_pred, mass, eps, p.valid, box=box,
                                depth=default_depth(p.n_padded),
                                uniform_eps=self._uniform_eps)
            if use_lists:
                # skin for the coming cycle: displacement rate x last dt x
                # K, with a 2.5 safety. The JAX package's floor (half the
                # deepest cell) reads the tree cache it has just cleared,
                # so it never applies (ROADMAP C.2): reproduced, the first
                # cycle's skin is 0.
                self._skin_now = (2.5 * self._disp_rate * self._last_dt
                                  * refresh_steps)
                lists = record_lists(
                    tree, p.old_acc[tree.perm], (mass > 0)[tree.perm],
                    theta=cfg.ErrTolTheta,
                    use_relative=cfg.TypeOfOpeningCriterion == 1,
                    err_tol_force_acc=cfg.ErrTolForceAcc, lcfg=self._lfc,
                    skin=self._skin_now, vel=p.vel, t_now=t_next)
                ovf, need = lists.ovf.tolist(), lists.need.tolist()
                # any dropped entry is a force with missing pairs, the
                # walk caps' drops (ovf[0]) included (ROADMAP C.8): the
                # walk recomputes the step
                if sum(ovf):
                    self._list_overflow(ovf, need)
                    raw_acc, pot, info = self._walk(tree, mass, eps,
                                                    p.old_acc)
                else:
                    raw_acc, pot = eval_lists(tree, lists, mass, eps,
                                              need_pot=False)
                    kind = "record"
                    self._lists_cache = lists
                    # DIAG interaction counters (gravtree.c:356-393)
                    nlive = torch.sum(lists.gvalid, dim=1)
                    self._diag_far = int(torch.sum(lists.nf * nlive))
                    self._diag_near = int(torch.sum(lists.nn * nlive))
                self._steps_since_build = 0
            else:
                raw_acc, pot, info = self._walk(tree, mass, eps, p.old_acc)
            self._refresh_left = refresh_steps - 1
            self._t_rebuild = float(t_next)
        if self._use_treepm():
            clock.mark("force")
            raw_acc, pot = self._add_mesh(raw_acc, pot, pos_pred, mass,
                                          p.valid, False)
            clock.mark("pm")
        accel, old_acc = integrate.apply_accel_postfactors(
            raw_acc, pos_pred, vel_pred, t_next, consts)
        p = dataclasses.replace(
            p, accel=torch.where(active[:, None], accel, p.accel),
            old_acc=torch.where(active, old_acc, p.old_acc),
            pot=torch.where(active, pot, p.pot))
        self.last_step_rebuilt = not reuse
        self.last_walk_info = info
        self.last_list_info = (dict(kind=kind, skin=self._skin_now, md=md,
                                    ovf=ovf, need=need)
                               if cfg.ListMode else None)
        if not use_lists and self._refresh_left > 0:
            # walk only: early rebuild once the guard inflation reaches a
            # quarter of the deepest cell (simulation.py:991-999)
            s_deep = float(tree.extent) / (1 << tree.depth)
            if float(tree.drift) > 0.25 * s_deep:
                self._refresh_left = 0
        if kind != "list" or not drift_mode:
            # a drift-mode list step's tree is the advanced copy: keep the
            # rebuild-time base, from which advance_tree is absolute
            self._tree_cache = tree
        clock.mark("force")
        p = self._veldisp(p, pos_pred, vel_pred, active, clock)

        n_scat = 0
        self.last_sidm_info = None
        if cfg.SIDMOn and cfg.CrossSection > 0:
            key = step_key(self.root_key,
                           0x7FFFFFFF if first else self.step_count)
            p, n_scat = self._sidm(p, pos_pred, tree, t_next, active, vmax,
                                   key, use_lists, clock)
        return self._finish(p, t_next, active, vmax, params, first, clock,
                            n_scat)

    def _finish(self, p, t_next, active, vmax, params, first: bool, clock,
                n_scat: int):
        """The finish phase (simulation.py:726-741): advance (which applies
        the kicks), reflection, the active particles' new timesteps (all
        particles given the global minimum unless ``mode="individual"``),
        vmax; then the Simulation's time, counters and scatter log."""
        cfg, consts = self.cfg, self.consts
        p = integrate.advance(p, t_next, active, consts)
        if consts.reflection_radius > 0:
            p = integrate.reflect(p, consts.reflection_radius)
        if consts.periodic:
            p = integrate.box_wrap(p, consts.box_size)
        new_mpt = timestep.find_timesteps(p, t_next, active, vmax, params,
                                          first=first)
        if self.mode != "individual":
            mpt_min = torch.min(torch.where(
                p.valid, new_mpt, torch.full_like(new_mpt, MAX_REAL_NUMBER)))
            new_mpt = torch.where(p.valid, mpt_min, new_mpt)
        p = dataclasses.replace(p, max_pred_time=new_mpt)
        vmax_new = timestep.get_vmax(p)
        n_active = torch.sum(active.to(torch.int32))
        clock.mark("finish")

        self.particles = p
        self.last_phase_wall = clock.seconds()
        prev_time = self.time
        self.time = float(t_next)
        if self.time > prev_time:
            self._last_dt = self.time - prev_time
        self.vmax = float(vmax_new)
        if not first:
            self.step_count += 1
            if cfg.ScatterLog and self.last_sidm_info is not None \
                    and "events" in self.last_sidm_info:
                self._write_scatter_log(self.last_sidm_info["events"])
        return self.time - prev_time, int(n_active), n_scat

    # ------------------------------------------------------------------- SIDM

    def _sidm_params(self) -> SidmParams:
        return sidm_params(self.cfg, self.units)

    def _event_info(self, info, n_scat: int) -> dict:
        """The scatter log's part of ``last_sidm_info``: the step's events
        (records on the device, their count: the scatters up to the event
        cap, known without a read) and the scatters past the cap."""
        if "events" not in info:
            return {}
        cap = self._sidm_params().event_cap
        rec, ids, _ = info["events"]
        return dict(events=(rec, ids, min(n_scat, cap)),
                    events_dropped=max(n_scat - cap, 0))

    def _sidm(self, p, pos_pred, tree, t_next, active, vmax, key,
              use_lists: bool, clock):
        """The SIDM block of step_phased (simulation.py:1013-1262): on the
        list cadence the candidate record on rebuild steps and the DSMC
        pass on the cached lists every step; on the walk (``ListMode 0``,
        given-up force lists, or an exhausted candidate cap refit) the
        DSMC pass on the range walk. Returns (particles, n_scattered)."""
        params = self._sidm_params()
        if not use_lists or self._sidm_lists_disabled:
            return self._sidm_walk(p, pos_pred, tree, t_next, active, vmax,
                                   key, params, dict(record=False), clock)
        info = dict(record=False)
        if self._sidm_cands is None or self._steps_since_build == 0:
            # ensure_neighbours-style clamp (sidm.c:814-968): stale-large
            # smoothing lengths to 2.5x a cell-count density bound, once
            # per rebuild
            cap = 2.5 * cell_count_hsml_seed(tree, int(params.des_num_ngb))
            p = dataclasses.replace(p, hsml_vd=torch.where(
                p.is_collisionless & p.valid & (cap > 0),
                torch.minimum(p.hsml_vd, cap), p.hsml_vd))
            self._sidm_cands = None
            self._sidm_cands = self._sidm_record(p, pos_pred, tree, params)
            info.update(record=True)
            clock.mark("sidmrec")
            if self._sidm_cands is None:
                # the refit is exhausted: the walk from this step on
                return self._sidm_walk(p, pos_pred, tree, t_next, active,
                                       vmax, key, params, info, clock)
        cands = self._sidm_cands
        p, n_scat, viol, ovf_g, sinfo = sidm_scatter_lists(
            p, pos_pred, tree, cands, t_next, active, vmax, key, params,
            rcfg=self._sidm_rcfg, salt=self.step_count & 0xFFFFFFFF)
        # mid-cycle re-record trigger: displacement only (2 md > skin)
        d = tree.pos_s - cands.pos_ref
        md_s = torch.sqrt(torch.max(torch.sum(d * d, dim=-1)))
        # the step's host reads, at once
        md_s, viol, n_scat, n_gated, n_prop, *ints = torch.cat([
            torch.stack([md_s.double(), viol.double(), n_scat.double(),
                         torch.sum(sinfo["hs"] > 0).double(),
                         torch.sum(sinfo["proposal"] >= 0).double()]),
            ovf_g.double(), cands.ovf.double(),
            cands.need.double()]).tolist()
        ovf_g = [int(x) for x in ints[:2]]
        n_scat = int(n_scat)
        if 2.0 * md_s > float(cands.skin):
            self._sidm_cands = None
        if ovf_g[0] > 0 or ovf_g[1] > 0:
            self._sidm_capacity_overflow(ovf_g)
        info.update(engine="lists", n_scat=n_scat, viol=viol, ovf_g=ovf_g,
                    md=md_s, cand_ovf=[int(x) for x in ints[2:4]],
                    cand_need=[int(x) for x in ints[4:6]],
                    kick=sinfo["kick"], rounds=sinfo["rounds"],
                    proposals=int(n_prop), dropped=sinfo["dropped"],
                    n_gated=int(n_gated), **self._event_info(sinfo, n_scat))
        self.last_sidm_info = info
        clock.mark("sidm")
        return p, n_scat

    def _grow_hash_cap(self, need: int, what: str) -> bool:
        """Grow the hash engine's rows per bucket to ``need`` (rounded up to
        32) when it is past the cap and growth is on; True if it grew."""
        if not self.HASH_CAP_GROWTH or need <= self._hash_cap:
            return False
        old, self._hash_cap = self._hash_cap, self._round_cap(need, 32)
        print(f"NOTE: the hash grid's {what} reached a bucket of {need} "
              f"rows past cap {old}: cap -> {self._hash_cap}, pass redone.",
              file=sys.stderr, flush=True)
        return True

    def _sidm_hash(self, p, pos_pred, t_next, active, vmax, key):
        """The hash engine's DSMC pass (``sidm_scatter``) with its rows per
        bucket grown to the step's demand: a pass that read a bucket past
        the cap is redone with the cap grown (up to HASH_TRIES passes).
        What still drops (``ngb_ovf``: queries and targets past the cap;
        ``lvl_clip``: those whose level was clipped, so that their stencil
        misses part of their ball) is a rate biased low: reported."""
        if self._hash_step is None:
            self._hash_step = make_sidm_step(self.cfg, self.units)
        for tries in range(1, self.HASH_TRIES + 1):
            q, n_scat, info = self._hash_step(p, pos_pred, t_next, active,
                                              vmax, key, cap=self._hash_cap)
            need, ovf, clip, n_scat, n_prop = (int(x) for x in torch.stack([
                info["need"].long(), info["ngb_ovf"].long(),
                info["lvl_clip"].long(), n_scat.long(),
                torch.sum(info["proposal"] >= 0).long()]).tolist())
            if tries == self.HASH_TRIES or not self._grow_hash_cap(
                    need, "DSMC pass"):
                break
        if ovf or clip:
            print(f"WARNING: the hash DSMC pass read {ovf} buckets past cap "
                  f"{self._hash_cap} and clipped {clip} levels this step "
                  f"(scattering rate biased low).", file=sys.stderr,
                  flush=True)
        self.last_sidm_info = dict(
            record=False, engine="hash", n_scat=n_scat, cap=self._hash_cap,
            need=need, ngb_ovf=ovf, lvl_clip=clip, tries=tries,
            kick=info["kick"], rounds=info["rounds"], proposals=n_prop,
            dropped=info["dropped"], n_gated=info["n_gated"],
            knn=info["knn"], scan=info["scan"], tid=info["tid"],
            **self._event_info(info, n_scat))
        return q, n_scat

    def _veldisp(self, p, pos_pred, vel_pred, active, clock):
        """The velocity-dispersion pass (``VelDispOn 1``; JAX's
        ``veldisp`` right after the force) with its rows per bucket and its
        grid's levels grown to the pass's demand: a pass that read a bucket
        past the cap, or clipped a query's level (its stencil then misses
        part of its ball), is redone with the cap grown (``_grow_hash_cap``,
        shared with the hash DSMC engine, which VelDispOn excludes) and the
        levels grown to cover the largest radius, up to HASH_TRIES passes.
        What still drops is reported. Returns the particles; the pass's
        numbers in ``last_veldisp_info``."""
        cfg = self.cfg
        if not cfg.VelDispOn:
            self.last_veldisp_info = None
            return p
        box = cfg.BoxSize if cfg.PeriodicBoundariesOn else 0.0
        for tries in range(1, self.HASH_TRIES + 1):
            q, info = veldisp(p, pos_pred, vel_pred, active,
                              des_num_ngb=cfg.DesNumNgb, box=box,
                              cap=self._hash_cap, n_levels=self._vd_levels)
            rows = info["rows"].double()
            need, ovf, clip, ratio, rows_mean, rows_max = torch.stack([
                info["need"].double(), info["ngb_ovf"].double(),
                info["lvl_clip"].double(),
                info["h_max"].double() / info["table"].s0.double(),
                torch.mean(rows), torch.max(rows)]).tolist()
            need, ovf, clip = int(need), int(ovf), int(clip)
            grew = self._grow_hash_cap(need, "velocity-dispersion pass")
            if clip and self.HASH_CAP_GROWTH:
                # the last level's cells s0 2^(L-1) must reach the largest
                # radius, with one level to spare for the redone pass
                want = min(max(self._vd_levels + 1,
                               int(np.ceil(np.log2(max(ratio, 1.0)))) + 2),
                           MAX_VD_LEVELS)
                if want > self._vd_levels:
                    print(f"NOTE: the velocity-dispersion pass clipped "
                          f"{clip} queries' levels at {self._vd_levels} "
                          f"levels: levels -> {want}, pass redone.",
                          file=sys.stderr, flush=True)
                    self._vd_levels = want
                    grew = True
            if tries == self.HASH_TRIES or not grew:
                break
        if ovf or clip:
            print(f"WARNING: the velocity-dispersion pass read {ovf} buckets "
                  f"past cap {self._hash_cap} and clipped {clip} levels this "
                  f"step (truncated neighbour sums).", file=sys.stderr,
                  flush=True)
        self.last_veldisp_info = dict(
            cap=self._hash_cap, levels=self._vd_levels, need=need,
            ngb_ovf=ovf, lvl_clip=clip, tries=tries,
            queries=info["queries"], rows_mean=rows_mean,
            rows_max=int(rows_max))
        clock.mark("veldisp")
        return q

    def _sidm_walk(self, p, pos_pred, tree, t_next, active, vmax, key,
                   params, info, clock):
        """The DSMC pass on the range walk (``sidm_scatter_wq``), its
        segment lists and walk caps grown to the walk's demand and kept
        across steps. What it still drops (cells past the walk's caps,
        particles past the overfull cells' chunks) is a rate biased low:
        reported, never silent."""
        p, n_scat, w = sidm_scatter_wq(
            p, pos_pred, tree, t_next, active, vmax, key, params,
            cfg=self._walk_fcfg, salt=self.step_count & 0xFFFFFFFF,
            return_info=True, seg_cap=self._walk_seg_cap)
        self._walk_seg_cap = max(self._walk_seg_cap, int(w["seg_cap"]))
        self._walk_fcfg = w["cfg"]
        n_scat, n_gated, n_prop, *drops = (int(x) for x in torch.stack([
            n_scat.long(), w["n_gated"].long(),
            torch.sum(w["proposal"] >= 0).long(), w["ovf_walk"],
            w["ovf_big"], w["ovf_seg"]]).tolist())
        if sum(drops):
            print(f"WARNING: the DSMC range walk dropped cells {drops[0]}, "
                  f"overfull-cell particles {drops[1]}, segments "
                  f"{drops[2]} this step (scattering rate biased low).",
                  file=sys.stderr, flush=True)
        info.update(engine="walk", n_scat=n_scat, walk_ovf=drops,
                    ovf_g=[0, 0], seg_cap=self._walk_seg_cap,
                    walk_caps=tuple(w["cfg"]),
                    groups=int(w["groups"]), kick=w["kick"],
                    rounds=w["rounds"], proposals=n_prop,
                    dropped=w["dropped"], n_gated=n_gated,
                    **self._event_info(w, n_scat))
        self.last_sidm_info = info
        clock.mark("sidm")
        return p, n_scat

    def _sidm_record(self, p, pos_pred, tree, params):
        """The candidate record with up to 4 attempts: a cap overflow refits
        the caps from the recorded demand and records again; K truncation
        alone at the ceiling is accepted (its dropped share kept). None
        once the refit is exhausted: the candidate lists are given up for
        the walk."""
        for _ in range(4):
            cands = record_candidates_from_particles(
                p, pos_pred, tree, skin=self._skin_now, params=params,
                rcfg=self._sidm_rcfg)
            covf = cands.ovf.tolist()
            if not (covf[0] or covf[1]):
                break
            need = cands.need.tolist()
            rc = self._sidm_rcfg or RangeListConfig()
            if covf[0] == 0 and rc.k_cap >= self.SIDM_K_CEILING:
                # K truncation only, at the ceiling: accept; dropped
                # candidates over all recorded ones bound the probability
                # mass the truncated lists can lose this cycle
                ncand_tot = int(torch.sum(cands.ncand))
                self.sidm_trunc_targets = int(torch.sum(cands.ncand
                                                        >= rc.k_cap))
                self.sidm_trunc_frac = covf[1] / max(ncand_tot, 1)
                if not self._sidm_k_warned:
                    self._sidm_k_warned = True
                    print(f"NOTE: SIDM candidate lists truncate at "
                          f"K={rc.k_cap} for {self.sidm_trunc_targets} "
                          f"outlier targets (demand {need[1]}); dropped "
                          f"candidates = {self.sidm_trunc_frac:.2%} of "
                          f"recorded probability mass (upper bound).",
                          file=sys.stderr, flush=True)
                break
            refit = self._refit_sidm_caps(need)
            print(f"WARNING: SIDM candidate caps overflowed (seg={covf[0]} "
                  f"k={covf[1]}; demand seg/grp={need[0]} "
                  f"k/part={need[1]}); "
                  + ("resized caps, re-recording." if refit else
                     "cap refit exhausted - falling back to the range "
                     "walk."), file=sys.stderr, flush=True)
            if not refit:
                self._sidm_lists_disabled = True
                return None
            cands = None
        # fit the tail capacity once, generously, to the long lists
        rc = self._sidm_rcfg or RangeListConfig()
        n_long = int(torch.sum(cands.ncand > min(rc.k_dense, rc.k_cap)))
        fit = max(16384, self._round_cap(4.0 * n_long, 4096))
        if self._sidm_tail_pending > rc.tail_cap:
            self._sidm_rcfg = rc._replace(
                tail_cap=max(self._sidm_tail_pending, fit))
            self._sidm_tail_pending = 0
        elif rc.tail_cap == 0:
            self._sidm_rcfg = rc._replace(tail_cap=fit)
        return cands

    def _refit_sidm_caps(self, need) -> bool:
        """Grow the candidate caps from the recorded demand (need =
        [segments/group, candidates/particle]); False once SIDM_REFITS
        refits are spent or nothing would grow."""
        if self._sidm_refits >= self.SIDM_REFITS:
            return False
        cur = self._sidm_rcfg or RangeListConfig()
        new = cur._replace(
            seg_cap=max(cur.seg_cap, self._round_cap(1.15 * int(need[0]))),
            k_cap=max(cur.k_cap, min(self._round_cap(1.25 * int(need[1]), 32),
                                     self.SIDM_K_CEILING)))
        new = new._replace(lvl_cap=max(new.lvl_cap, new.seg_cap))
        if new == cur:
            return False
        self._sidm_rcfg = new
        self._sidm_refits += 1
        return True

    def _sidm_capacity_overflow(self, ovf_g):
        """A gated or tail capacity dropped targets this step: the gated
        capacity grows at once, the tail's at the next record."""
        cur = self._sidm_rcfg or RangeListConfig()
        new = cur
        if ovf_g[0] > 0:
            new = new._replace(gated_frac=min(1.0, 1.6 * new.gated_frac))
        if ovf_g[1] > 0:
            want = self._round_cap(1.6 * (cur.tail_cap or 4096) + ovf_g[1],
                                   4096)
            self._sidm_tail_pending = max(self._sidm_tail_pending, want)
        self._sidm_rcfg = new
        print(f"WARNING: gated/tail target caps exceeded by {ovf_g[0]}/"
              f"{ovf_g[1]} this step (targets dropped); gated_frac -> "
              f"{new.gated_frac:.2f}, tail growth deferred to the next "
              f"rebuild.", file=sys.stderr, flush=True)

    def _walk(self, tree, mass, eps, old_acc):
        """The work-queue walk on ``tree``: (raw acc, pot (0), info)."""
        cfg = self.cfg
        return wq_gravity_tree(
            tree, mass, eps, old_acc, theta=cfg.ErrTolTheta,
            opening=cfg.TypeOfOpeningCriterion,
            err_tol_force_acc=cfg.ErrTolForceAcc, need_pot=False,
            return_info=True, pbc=self._pbc())

    @staticmethod
    def _round_cap(v, mult=128):
        return int(-(-int(v) // mult) * mult)

    def _refit_list_caps(self, need) -> bool:
        """Grow the list caps from the recorded demand (need = [far/group,
        near/group, used nodes]) and restart the cadence (the JAX package
        re-jits its phases, which resets it). There is no level cap to grow
        (ROADMAP C.8), and the walk caps behind ``ovf[0]`` are not refit.
        False once LIST_REFITS refits are spent or nothing would grow."""
        if self._list_refits >= self.LIST_REFITS:
            return False
        cur = self._lfc
        new = cur._replace(
            far_cap=max(cur.far_cap, self._round_cap(1.15 * int(need[0]))),
            near_cap=max(cur.near_cap, self._round_cap(1.15 * int(need[1]))),
            used_cap=max(cur.used_cap,
                         self._round_cap(1.15 * int(need[2]), 4096)))
        if new == cur:
            return False
        self._lfc = new
        self._list_refits += 1
        self._cadence_stale = True
        return True

    def _list_overflow(self, ovf, need):
        """A record overflowed a list cap: the step is recomputed with the
        walk; the caps are refit, or the lists are given up for good."""
        refit = self._refit_list_caps(need)
        if not refit:
            self._lists_disabled = True
        print(f"WARNING: interaction-list caps overflowed (walk={ovf[0]} "
              f"far={ovf[1]} near={ovf[2]} used={ovf[3]}; demand "
              f"far/grp={need[0]} near/grp={need[1]} used={need[2]}); "
              + ("resized caps, re-recording next rebuild." if refit else
                 "no cap refit left or none would help - falling back to "
                 "the per-step walk."),
              file=sys.stderr, flush=True)

    def prepare(self):
        """init() (nbody/init.c:20-199): initial SIDM smoothing lengths,
        first force evaluation at TimeBegin (dt = 0), initial timesteps,
        initial system state."""
        if self.particles is None:
            raise RuntimeError("load particles first")
        cfg, p = self.cfg, self.particles
        if cfg.ComovingIntegrationOn and cfg.PeriodicBoundariesOn:
            self.check_omega()
        if cfg.SIDMOn and cfg.CrossSection > 0 and not self._use_phased():
            # setup_smoothinglengths_sidm (init.c:159) on the hash grid,
            # simulation.py:1318-1322, its cap grown to the demand
            for _ in range(self.HASH_TRIES):
                q, knn = setup_smoothing_lengths(
                    p, cfg.DesNumNgb, cfg.MaxNumNgbDeviation,
                    cap=self._hash_cap, return_info=True)
                need = int(torch.max(knn.need))
                if not self._grow_hash_cap(need, "smoothing-length init"):
                    break
            col = p.is_collisionless
            self.particles = q
            self.last_hsml_init = dict(
                cap=self._hash_cap, need=need,
                ngb_ovf=int(torch.sum(col & (knn.need > self._hash_cap))),
                lvl_clip=int(torch.sum(col & knn.clip)))
        elif cfg.SIDMOn and cfg.CrossSection > 0:
            # setup_smoothinglengths_sidm (init.c:159)
            eps = self._softening()[torch.clamp(p.ptype, 0, 5).long()]
            tree = build_octree(p.pos, torch.where(p.valid, p.mass,
                                                   torch.zeros_like(p.mass)),
                                eps, p.valid, depth=default_depth(p.n_padded))
            self.particles = tree_hsml_init_fused(p, tree, cfg.DesNumNgb)
            del tree
        self.vmax = float(timestep.get_vmax(self.particles))
        self.step(first=True)
        self.sys_state_at_start = compute_system_state(self.particles)

    def compute_potential(self):
        """compute_potential (potential.c:18-195) at the current time, with
        the JAX package's force function for ``ForceMethod``
        (simulation.py:1550-1575): a fresh tree's walk (TreePM in a periodic
        box), or the direct sum; comoving runs without a box lose
        Omega0 H0^2 r^2 / 2, physical ones OmegaLambda H0^2 r^2 / 2."""
        cfg, p = self.cfg, self.particles
        t = torch.tensor(self.time, dtype=self.dtype, device=self.device)
        pos_pred, _ = integrate.predict_positions(p, t, self.consts)
        _, pot, _ = self._force(p, pos_pred, self._softening(), True)
        H = self.units.Hubble
        pot = self.units.G * pot
        omega = (0.0 if cfg.PeriodicBoundariesOn else cfg.Omega0) \
            if cfg.ComovingIntegrationOn else cfg.OmegaLambda
        if omega != 0:
            r2 = torch.sum(pos_pred * pos_pred, dim=-1)
            pot = pot - 0.5 * omega * H * H * r2
        self.particles = dataclasses.replace(p, pot=pot)
        return pot

    # ------------------------------------------------------------------ run()

    def _write_scatter_log(self, events):
        """Append the step's events to ``sct_XXX.0`` in OutputDir
        (SCATTERLOG, sidm.c:96-104, 571-601; struct scatlog sidm.h:1-10):
        20 x 4 bytes per record, [time f32, id1 i32, id2 i32, h1, h2,
        x1(3), x2(3), v1(3), v2(3), dv(3) f32]. The records are packed on
        the device and copied to the host at once. ``events`` = (rec, ids,
        count), as ``collect_events`` gives them."""
        rec, ids, cnt = events
        cnt = int(cnt)
        if cnt == 0:
            return
        rec = rec[:cnt].to(torch.float32)
        out = torch.cat([rec[:, :1], ids[:cnt].view(torch.float32),
                         rec[:, 1:]], dim=1).cpu().numpy()
        path = os.path.join(self.cfg.OutputDir,
                            f"sct_{self.snapshot_count:03d}.0")
        with open(path, "ab") as f:
            out.tofile(f)

    def _open_logs(self, append: bool):
        d = self.cfg.OutputDir
        os.makedirs(d, exist_ok=True)
        self.energy_log = EnergyLog(os.path.join(d, self.cfg.EnergyFile),
                                    append)
        self.info_log = InfoLog(os.path.join(d, self.cfg.InfoFile), append)
        self.cpu_log = CpuLog(os.path.join(d, self.cfg.CpuFile), append)
        self.timings_log = TimingsLog(
            os.path.join(d, self.cfg.TimingsFile), append)
        self._logs_open = True

    def close_logs(self):
        if self._logs_open:
            for log in (self.energy_log, self.info_log, self.cpu_log,
                        self.timings_log):
                log.close()
            self._logs_open = False

    def run(self, max_steps: Optional[int] = None) -> int:
        """Main loop (run.c:17-221) until TimeMax, a stop or ``max_steps``
        (the step count, which a resumed run continues); returns the step
        count. The logs are opened to append on a resumed run."""
        cfg = self.cfg
        if not self._logs_open:
            self._open_logs(append=self.restart_flag == 1)
        if self.sys_state_at_start is None:
            self.prepare()
        # the steps end at TimeMax rounded to the state's dtype (JAX compares
        # with TimeMax itself and never ends where the rounding is below
        # it; ROADMAP C.10)
        t_max = float(torch.tensor(cfg.TimeMax, dtype=self.dtype))
        stop = False
        while self.time < t_max and not stop:
            if max_steps is not None and self.step_count >= max_steps:
                break
            t0 = _wallclock.perf_counter()

            # statistics cadence (run.c:51-59)
            if (cfg.TimeBetStatistics > 0 and self.time
                    - self.time_last_statistics >= cfg.TimeBetStatistics):
                self.energy_statistics()
                self.time_last_statistics += cfg.TimeBetStatistics

            # snapshot cadence (run.c:61-74)
            if cfg.TimeBetSnapshot > 0 and \
                    self.time - self.time_of_first_snapshot >= 0:
                with Timer(self.cpu_log, "Snapshot"):
                    self.write_snapshot_file(self.snapshot_count)
                self.snapshot_count += 1
                if cfg.OutputListOn and cfg.OutputListTimes:
                    nxt = [t for t in cfg.OutputListTimes if t > self.time]
                    self.time_of_first_snapshot = (nxt[0] if nxt
                                                   else MAX_REAL_NUMBER)
                elif cfg.ComovingIntegrationOn:
                    # comoving: snapshots at scale factors a ratio apart
                    self.time_of_first_snapshot *= cfg.TimeBetSnapshot
                else:
                    self.time_of_first_snapshot += cfg.TimeBetSnapshot

            dt, n_active, n_scat = self.step()
            self.info_log.write(self.step_count, self.time, n_active, dt)
            if cfg.FindNbrLog and n_scat:
                print(f"SCT {n_active} {n_scat}")

            step_wall = _wallclock.perf_counter() - t0
            self.cpu_this_run += step_wall
            # per-phase buckets from the step's CUDA-event clock
            # (run.c:250-285 FdCPU analog)
            ph = self.last_phase_wall
            self.cpu_log.add("Gravity", ph.get("force", 0.0)
                             + ph.get("pm", 0.0))
            self.cpu_log.add("Sidm", ph.get("sidm", 0.0)
                             + ph.get("veldisp", 0.0))
            self.cpu_log.add("EnsureNgb", ph.get("sidmrec", 0.0))
            self.cpu_log.add("TimeLine", ph.get("finish", 0.0))
            self.cpu_log.add("Predict", max(step_wall - sum(ph.values()),
                                            0.0))
            # sub-buckets: force time split by rebuild vs reuse steps
            self.cpu_log.add_sub("TreeConstruction" if self.last_step_rebuilt
                                 else "TreeWalk", ph.get("force", 0.0))
            self.cpu_log.write(self.step_count, self.time)
            self.timings_log.write(self.step_count, self.time, n_active,
                                   n_pairs=self._diag_far,
                                   n_segs=self._diag_near, wall_s=step_wall)

            # interruption checks (run.c:152-202)
            if ckpt.stopfile_present(cfg.OutputDir):
                stop = True
            if self.cpu_this_run > 0.85 * cfg.TimeLimitCPU:
                stop = True
                # CPU-limit self-stop with optional resubmission
                # (run.c:169-181): fire the user's resubmit command once
                if cfg.ResubmitOn and cfg.ResubmitCommand not in ("", "none"):
                    try:
                        subprocess.Popen(cfg.ResubmitCommand, shell=True)
                    except OSError as e:
                        print(f"resubmit command failed: {e}",
                              file=sys.stderr)
            if (self.cpu_this_run - self.time_last_restart
                    >= cfg.CpuTimeBetRestartFile):
                self.write_restart_file()
                self.time_last_restart = self.cpu_this_run

        self.write_restart_file()
        if self.time >= t_max:
            self.write_snapshot_file(self.snapshot_count)
            self.snapshot_count += 1
        return self.step_count

    # ------------------------------------------------------------- I/O pieces

    def _predicted_host_state(self):
        """(pos, vel) predicted to the current time (positions wrapped onto
        a periodic box), as numpy arrays."""
        t = torch.tensor(self.time, dtype=self.dtype, device=self.device)
        pos, vel = integrate.predict_positions(self.particles, t,
                                               self.consts)
        if self.cfg.PeriodicBoundariesOn:
            box = self.cfg.BoxSize
            pos = pos - box * torch.floor(pos / box)
        return pos.cpu().numpy(), vel.cpu().numpy()

    def write_snapshot_file(self, count: int):
        """``<OutputDir>/<SnapshotFileBase>_<count>``: the valid particles
        predicted to the current time (io.c savepositions)."""
        p = self.particles
        valid = p.valid.cpu().numpy()
        pos, vel = self._predicted_host_state()
        hdr = GadgetHeader(time=self.time,
                           redshift=(1.0 / self.time - 1.0
                                     if self.cfg.ComovingIntegrationOn
                                     else 0.0),
                           box_size=self.cfg.BoxSize, omega0=self.cfg.Omega0,
                           omega_lambda=self.cfg.OmegaLambda,
                           hubble_param=self.cfg.HubbleParam)
        snap = Snapshot(header=hdr, pos=pos[valid], vel=vel[valid],
                        pid=p.pid.cpu().numpy()[valid].astype(np.uint32),
                        mass=p.mass.cpu().numpy()[valid],
                        ptype=p.ptype.cpu().numpy()[valid])
        base = os.path.join(self.cfg.OutputDir,
                            f"{self.cfg.SnapshotFileBase}_{count:03d}")
        return write_snapshot(base, snap,
                              num_files=max(1, self.cfg.NumFilesPerSnapshot))

    def energy_statistics(self):
        """energy_statistics (run.c:295-330): the potential at the current
        time, the system state, and its line in the energy log when the
        logs are open; returns the state (numpy fields)."""
        log = self.cpu_log if self._logs_open else None
        with Timer(log, "Potential"):
            self.compute_potential()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        with Timer(log, "Diagnostic"):
            sys_state = system_state_to_host(
                compute_system_state(self.particles))
            if self._logs_open:
                self.energy_log.write(self.time, sys_state)
        return sys_state

    def write_restart_file(self):
        base = os.path.join(self.cfg.OutputDir, self.cfg.RestartFile)
        run_vars = dict(
            time=self.time, step_count=self.step_count,
            snapshot_count=self.snapshot_count,
            time_last_statistics=self.time_last_statistics,
            time_of_first_snapshot=self.time_of_first_snapshot,
            vmax=self.vmax, cpu_this_run=self.cpu_this_run)
        return ckpt.write_restart(base, self.particles, run_vars)

    def load_restart_file(self):
        base = os.path.join(self.cfg.OutputDir, self.cfg.RestartFile)
        p, rv = ckpt.read_restart(base, device=self.device)
        self.particles = p
        self.time = rv["time"]
        self.step_count = rv["step_count"]
        self.snapshot_count = rv["snapshot_count"]
        self.time_last_statistics = rv["time_last_statistics"]
        self.time_of_first_snapshot = rv["time_of_first_snapshot"]
        self.vmax = rv["vmax"]
        self.cpu_this_run = 0.0
        if self.sys_state_at_start is None:
            self.sys_state_at_start = compute_system_state(p)
