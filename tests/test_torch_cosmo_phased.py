"""Periodic comoving runs of the port against the JAX package's, on the
CPU, on the phased step: cosmo-box (``flagship.COSMO``) at N = 2048 with
``PMGrid 64`` through ``Simulation(mode="phased")`` (three moments
refreshes of the periodic tree, then a rebuild), prepare + 4 steps and
``compute_potential``, held to JAX's states frozen in
tests/data/torch_periodic_golden.npz (``cp``; tolerances in
tests/torch_cosmo_checks.py); and JAX's comoving lattice
(tests/test_periodic_comoving.py:56-87 on the wq walk, ``lat``): frozen to
2e-3 box while the scale factor advances, at JAX's scale factor to 1e-6
and within 1e-6 box of JAX's positions.
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import LATTICE, lattice_config, lattice_ics
from tests.torch_cosmo_checks import load_golden, run_against_jax

torch.set_num_threads(2)


def test_cosmo_box_matches_jax_on_phased_step(tmp_path):
    kinds = run_against_jax(tmp_path, load_golden("cp"), "phased", "cp")
    assert kinds == [False, False, False, True]


def test_comoving_lattice_stays_static(tmp_path):
    golden = load_golden("lat")
    sim = Simulation(SimConfig(**lattice_config(OutputDir=str(tmp_path))),
                     mode="synchronized", device="cpu")
    pos, mass = lattice_ics(sim.units.G, sim.units.Hubble)
    n, box = len(pos), LATTICE["box"]
    sim.set_particles_from_arrays(pos, np.zeros_like(pos), mass,
                                  np.ones(n, np.int32), pad_to_multiple=n)
    sim.prepare()
    for _ in range(LATTICE["steps"]):
        sim.step()
    assert sim.time == pytest.approx(float(golden["lat_time"]), rel=1e-6)
    assert sim.time > 0.02
    got = sim.particles.pos.numpy()[:n]
    d = np.abs(got - pos)
    assert np.minimum(d, box - d).max() < 2e-3 * box
    d = np.abs(got - golden["lat_pos"][:n])
    assert np.minimum(d, box - d).max() <= 1e-6 * box
