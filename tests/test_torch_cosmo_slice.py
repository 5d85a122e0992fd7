"""Periodic comoving runs of the port against the JAX package's, on the
CPU: cosmo-box (``flagship.COSMO``) at N = 2048 with ``PMGrid 64`` through
``Simulation`` on the single-program step (``mode="synchronized"``: TreePM
on a fresh tree every step), prepare + 4 steps and ``compute_potential``,
held to JAX's states frozen in tests/data/torch_periodic_golden.npz
(``cs``; tolerances in tests/torch_cosmo_checks.py); ``check_omega``; and
the configurations once refused in and around a box, each named by its
ROADMAP.md item: the lists, DSMC and VelDispOn in a box, PMVacuum and
PMGrid -1 now construct.
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
    """The cached lists in a box (11.1), PMVacuum in an isolated run
    (11.2), PMGrid -1's Ewald walk (11.3), DSMC and VelDispOn in periodic
    comoving runs (11.4) are ported: each construct, on the force its
    item gives."""
    cfg = SimConfig(**periodic_config(OutputDir=str(tmp_path), **changes))
    sim = Simulation(cfg, mode="phased", device="cpu")
    assert all(getattr(sim.cfg, k) == v for k, v in changes.items())
    assert sim._use_vacuum_pm() == (item == "11.2")
    assert sim._use_ewald_walk() == (item == "11.3")
    assert sim._use_treepm() == (item not in ("11.2", "11.3"))
