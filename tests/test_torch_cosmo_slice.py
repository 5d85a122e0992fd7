"""Periodic comoving runs of the port against the JAX package's, on the
CPU: cosmo-box (``flagship.COSMO``) at N = 2048 with ``PMGrid 64`` through
``Simulation`` on the single-program step (``mode="synchronized"``: TreePM
on a fresh tree every step), prepare + 4 steps and ``compute_potential``,
held to JAX's states frozen in tests/data/torch_periodic_golden.npz
(``cs``; tolerances in tests/torch_cosmo_checks.py); ``check_omega``; and
what stays refused in a box, each naming its ROADMAP.md item.
"""

import dataclasses

import pytest
import torch

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import periodic_config
from tests.torch_cosmo_checks import cosmo_sim, load_golden, run_against_jax

torch.set_num_threads(2)


def test_cosmo_box_matches_jax_on_single_program_step(tmp_path):
    kinds = run_against_jax(tmp_path, load_golden("cs"), "synchronized",
                            "cs")
    assert all(kinds)


def test_check_omega_raises(tmp_path):
    sim = cosmo_sim(tmp_path, "synchronized")
    sim.particles = dataclasses.replace(sim.particles,
                                        mass=sim.particles.mass * 1.01)
    with pytest.raises(ValueError, match="check_omega"):
        sim.prepare()


@pytest.mark.parametrize("changes,item", [
    (dict(ListMode=1), "11.1"),
    (dict(PeriodicBoundariesOn=0, ComovingIntegrationOn=0, PMVacuum=1),
     "11.2"),
    (dict(PMGrid=-1), "11.3"),
    (dict(SIDMOn=1, CrossSection=1.0), "11.4"),
    (dict(VelDispOn=1), "11.4")])
def test_still_refused(tmp_path, changes, item):
    cfg = SimConfig(**periodic_config(OutputDir=str(tmp_path), **changes))
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        Simulation(cfg, mode="phased", device="cpu")
