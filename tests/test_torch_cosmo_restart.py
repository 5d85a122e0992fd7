"""A comoving periodic restart and the periodic direct sum's energy check,
the port on the CPU: a cosmo-box run (``flagship.cosmo_config`` at
N = 1024, mesh 32, on the single-program step) writes its restart file
mid-run; the file reads back bit-equal (state, scale factor, counters) and
the resumed run's steps equal the uninterrupted run's bit for bit.
tests/test_periodic_comoving.py:90-119's random periodic box with
``ForceMethod direct`` (the minimum image and the Ewald correction, 40
steps in physical time) keeps its energy drift below 0.2 of the kinetic
energy, that test's bar.
"""

import dataclasses
import os

import numpy as np
import torch

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.diagnostics import compute_system_state
from sidm_tpu_torch.flagship import cosmo_config, cosmo_ics
from sidm_tpu_torch.simulation import Simulation

torch.set_num_threads(2)


def test_comoving_restart_resumes_bit_equal(tmp_path):
    """A restart written mid-run reads back bit-equal (state, scale factor,
    counters) and the resumed run's steps equal the uninterrupted run's."""
    n = 1024
    a = Simulation(cosmo_config(n, PMGrid=32, OutputDir=str(tmp_path)),
                   device="cpu")
    a.set_particles_from_arrays(*cosmo_ics(n, 4), np.ones(n, np.int32))
    a.prepare()
    a.step()
    a.write_restart_file()
    saved = dataclasses.asdict(a.particles)
    a_time, a_steps = a.time, a.step_count
    for _ in range(2):
        a.step()
    b = Simulation(a.cfg, restart_flag=1, device="cpu")
    b.load_restart_file()
    assert b.time == a_time and b.step_count == a_steps
    for f, v in dataclasses.asdict(b.particles).items():
        if torch.is_tensor(v):
            assert torch.equal(v, saved[f]), f
    for _ in range(2):
        b.step()
    assert b.time == a.time > a_time
    for f, v in dataclasses.asdict(b.particles).items():
        if torch.is_tensor(v):
            assert torch.equal(v, getattr(a.particles, f)), f



def test_periodic_box_energy_stability(tmp_path):
    """tests/test_periodic_comoving.py:90-119 (physical time, ForceMethod
    direct with the Ewald correction): bounded energy drift."""
    rng = np.random.default_rng(6)
    n, box = 512, 10.0
    cfg = SimConfig(
        PeriodicBoundariesOn=1, BoxSize=box, GravityConstantInternal=1.0,
        ForceMethod="direct", TreeWalkEngine="wq", SIDMOn=0,
        TypeOfTimestepCriterion=1, ErrTolVelScale=0.1, MaxSizeTimestep=0.25,
        TimeMax=20.0, SofteningHalo=0.2, SofteningHaloMaxPhys=0.2,
        OutputDir=str(tmp_path), UnitLength_in_cm=1.0, UnitMass_in_g=1.0,
        UnitVelocity_in_cm_per_s=1.0)
    sim = Simulation(cfg, mode="synchronized", device="cpu")
    sim.set_particles_from_arrays(rng.uniform(0, box, (n, 3)),
                                  rng.normal(0, 0.02, (n, 3)),
                                  np.full(n, 1.0 / n), np.ones(n, np.int32),
                                  pad_to_multiple=n)
    sim.prepare()
    sim.compute_potential()
    s0 = compute_system_state(sim.particles)
    e0, k0 = float(s0.energy_kin + s0.energy_pot), float(s0.energy_kin)
    for _ in range(40):
        sim.step()
    sim.compute_potential()
    s1 = compute_system_state(sim.particles)
    assert abs(float(s1.energy_kin + s1.energy_pot) - e0) < 0.2 * k0
    assert os.path.exists(tmp_path / "ewald_table_torch_64.npz")
