"""The port's Simulation (sidm_tpu_torch.simulation) vs the JAX
``Simulation(mode="phased")`` on the slice: N = 2048 NFW halo of bench.py,
``SIDMOn 0``, ``TreeWalkEngine wq``, ``ListMode 0``, ``TreeRefreshSteps 2``
(so both a rebuild and a refresh step run), prepare + 3 steps, with
``compute_potential`` after prepare and at the end.

The fast tests hold the port against a frozen JAX output: the JAX
trajectory for these seeded inputs is tests/data/torch_slice_golden.npz,
written by tests/make_torch_golden.py (the JAX run takes ~100 s on one CPU,
mostly XLA compiles, over this suite's per-file budget). The ``slow`` test
reruns that JAX trajectory and holds the file to it. Held: time and
timesteps to rtol 1e-6; pos, vel, accel and pot to a max error of 1e-4 of
each array's largest magnitude; kinetic and potential energy
(compute_system_state) to 1e-5 relative."""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.diagnostics import compute_system_state
from sidm_tpu_torch.flagship import flagship_ics
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import (CONFIG, GOLDEN, N, SEED, STEPS,
                                     jax_trajectory)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def run():
    """The port's snapshots, keyed like the golden file."""
    pos, vel, mass = flagship_ics(N, SEED)
    sim = Simulation(SimConfig(**CONFIG), mode="phased", device="cpu")
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32))
    out, kinds = {}, []

    def snap(prefix):
        p = sim.particles
        s = compute_system_state(p)
        out[prefix + "time"] = sim.time
        for f in ("pos", "vel", "accel", "max_pred_time", "pot"):
            out[prefix + f] = getattr(p, f).numpy()
        out[prefix + "ekin"] = float(s.energy_kin)
        out[prefix + "epot"] = float(s.energy_pot)

    sim.prepare()
    snap("s0_")
    sim.compute_potential()
    snap("p0_")
    for k in range(1, STEPS + 1):
        sim.step()
        kinds.append(sim.last_step_rebuilt)
        snap(f"s{k}_")
    sim.compute_potential()
    snap(f"p{STEPS}_")
    return out, kinds


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def test_rebuild_and_refresh_steps_ran(run):
    _, kinds = run
    assert True in kinds and False in kinds


PREFIXES = ["s0_", "p0_"] + [f"s{k}_" for k in range(1, STEPS + 1)] \
    + [f"p{STEPS}_"]


def _check_state(out, ref, prefix):
    np.testing.assert_allclose(out[prefix + "time"], ref[prefix + "time"],
                               rtol=1e-6)
    np.testing.assert_allclose(out[prefix + "max_pred_time"],
                               ref[prefix + "max_pred_time"], rtol=1e-6)
    for f in ("pos", "vel", "accel", "pot"):
        scale = max(float(np.abs(ref[prefix + f]).max()), 1e-30)
        err = float(np.abs(out[prefix + f] - ref[prefix + f]).max()) / scale
        assert err <= 1e-4, (f, err)


def _check_energies(out, ref, prefix):
    for f in ("ekin", "epot"):
        np.testing.assert_allclose(out[prefix + f], ref[prefix + f],
                                   rtol=1e-5)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_state_matches_jax(run, golden, prefix):
    _check_state(run[0], golden, prefix)


@pytest.mark.parametrize("prefix", ["p0_", f"p{STEPS}_"])
def test_energies_match_jax(run, golden, prefix):
    _check_energies(run[0], golden, prefix)


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """The committed golden file is what the JAX Simulation gives now."""
    live = jax_trajectory()
    assert sorted(live) == sorted(golden)
    for prefix in PREFIXES:
        _check_state(golden, live, prefix)
    for prefix in ("p0_", f"p{STEPS}_"):
        _check_energies(golden, live, prefix)
