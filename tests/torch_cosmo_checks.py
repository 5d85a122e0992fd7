"""Shared pieces of tests/test_torch_cosmo_slice.py and
tests/test_torch_cosmo_phased.py: cosmo-box at tests/make_torch_golden.py's
PERIODIC size through the port's Simulation on the CPU, held to the JAX
states frozen in tests/data/torch_periodic_golden.npz.

Tolerances: the scale factor and the timesteps (max_pred_time) to 1e-6;
positions to 1e-6 of the box; velocities and accelerations to 2e-3 of
their largest magnitude (the screened pairs' erfc and exp by torch and by
XLA, the mesh's FFTs, summed in other orders, over 4 steps); the
potential to 2e-3 of its largest after removing the short range's mean
pi G M / (alpha^2 V), which the port adds and JAX leaves out (ROADMAP.md
C.18).
"""

import math

import numpy as np
import pytest
import torch

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.flagship import cosmo_ics
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import (PERIODIC, PERIODIC_GOLDEN,
                                     periodic_config)

N = PERIODIC["n"]


def load_golden(prefixes):
    with np.load(PERIODIC_GOLDEN) as z:
        return {k: z[k] for k in z.files if k.startswith(prefixes)}


def cosmo_sim(tmp, mode, **changes):
    """cosmo-box at N with PERIODIC's mesh, its ICs loaded, on the CPU."""
    sim = Simulation(SimConfig(**periodic_config(OutputDir=str(tmp),
                                                 **changes)),
                     mode=mode, device="cpu")
    pos, vel, mass = cosmo_ics(N, PERIODIC["seed"])
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32))
    return sim


def check_state(sim, golden, tag, pot=False):
    p = sim.particles
    assert sim.time == pytest.approx(float(golden[tag + "time"]), rel=1e-6)
    np.testing.assert_allclose(p.max_pred_time.numpy(),
                               golden[tag + "max_pred_time"], rtol=1e-6)
    box = sim.cfg.BoxSize
    d = np.abs(p.pos.numpy() - golden[tag + "pos"])
    assert np.minimum(d, box - d).max() <= 1e-6 * box
    for f in ("vel", "accel"):
        want = golden[tag + f]
        err = np.abs(getattr(p, f).numpy() - want).max()
        assert err <= 2e-3 * np.abs(want).max(), (tag, f, err)
    if pot:
        kern = sim._pm_kernel()
        mass = float(torch.sum(torch.where(p.valid, p.mass, 0.0)))
        mean = sim.units.G * math.pi * mass / (kern.alpha ** 2 * box ** 3)
        want = golden[tag + "pot"]
        err = np.abs(p.pot.numpy() - mean - want).max()
        assert err <= 2e-3 * np.abs(want).max(), (tag, "pot", err)


def run_against_jax(tmp, golden, mode, tag):
    """prepare + PERIODIC["steps"] steps + compute_potential, each state
    held to JAX's; no walk overflow; positions in [0, box). Returns
    whether each step rebuilt its tree."""
    sim = cosmo_sim(tmp, mode)
    assert sim._use_phased() == (mode == "phased")
    sim.prepare()
    check_state(sim, golden, f"{tag}0_")
    kinds = []
    for k in range(1, PERIODIC["steps"] + 1):
        sim.step()
        kinds.append(sim.last_step_rebuilt)
        check_state(sim, golden, f"{tag}{k}_")
        wi = sim.last_walk_info
        assert sum(int(wi[f]) for f in ("ovf_open", "ovf_big",
                                        "ovf_items")) == 0
    pos = sim.particles.pos
    assert float(pos.min()) >= 0.0 and float(pos.max()) < sim.cfg.BoxSize
    sim.compute_potential()
    check_state(sim, golden, f"{tag}p_", pot=True)
    return kinds
