"""The velocity-dispersion pass on the port's two steps, against the JAX
``Simulation`` on the input of JAX's
``test_phased_veldisp_matches_synchronized`` (tests/test_phased_mode.py:
1024 Plummer particles, ``VelDispOn 1``, criterion 2, with ``TreeWalkEngine
wq``), with JAX's runs frozen in tests/data/torch_veldisp_golden.npz
(``python -m tests.make_torch_golden veldisp``; the ``slow`` test of
tests/test_torch_individual.py reruns them): the single-program step (``mode=
"synchronized"``) and the phased step (``"phased"``), prepare + 3 steps at
JAX's fixed cap of 96 rows a bucket, each held to JAX's run in the same
mode (ngb_vd equal, positions to 5e-6 and vel_disp to 1e-5 as JAX's test
holds its two runs, hsml_vd, dens_vd and the kick times to 1e-5
relative), and the two to each other at JAX's bars.
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.simulation import Simulation
from sidm_tpu_torch.io import ics
from tests.make_torch_golden import (PVD, PVD_CONFIG, PVD_MODES, TRAJ_FIELDS,
                                     VELDISP_GOLDEN, plummer)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(VELDISP_GOLDEN))


@pytest.fixture(scope="module")
def pvd():
    out = {}
    for tag, mode in PVD_MODES.items():
        sim = Simulation(SimConfig(**PVD_CONFIG), mode=mode, device="cpu")
        sim.HASH_CAP_GROWTH = False
        sim.set_particles_from_arrays(*plummer(ics, PVD["n"], PVD["seed"]),
                                      pad_to_multiple=PVD["pad"])
        sim.prepare()
        for _ in range(PVD["steps"]):
            sim.step()
        out[tag] = sim
    return out


@pytest.mark.parametrize("tag", list(PVD_MODES))
def test_phased_veldisp_matches_jax(pvd, golden, tag):
    sim = pvd[tag]
    assert sim._use_phased() == (PVD_MODES[tag] == "phased")
    p = sim.particles
    want = {f: golden[f"pvd_{tag}_{f}"] for f in TRAJ_FIELDS}
    np.testing.assert_array_equal(p.ngb_vd.numpy(), want["ngb_vd"])
    np.testing.assert_allclose(p.pos.numpy(), want["pos"], atol=5e-6)
    np.testing.assert_allclose(p.vel_disp.numpy(), want["vel_disp"],
                               atol=1e-5)
    for f in ("hsml_vd", "dens_vd", "max_pred_time"):
        np.testing.assert_allclose(getattr(p, f).numpy(), want[f],
                                   rtol=1e-5, err_msg=f)
    assert sim.time == pytest.approx(float(golden[f"pvd_{tag}_time"]),
                                     rel=1e-6)


def test_phased_veldisp_matches_synchronized(pvd):
    a, b = pvd["s"].particles, pvd["p"].particles
    np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), atol=5e-6)
    np.testing.assert_allclose(a.vel_disp.numpy(), b.vel_disp.numpy(),
                               atol=1e-5)
