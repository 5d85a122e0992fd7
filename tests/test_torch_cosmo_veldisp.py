"""The velocity-dispersion pass in a periodic comoving box (ROADMAP A, item
11.4) against the JAX Simulation's, on the CPU: cosmo-veldisp
(``flagship.COSMO_VELDISP``: the cached lists in the box, ``VelDispOn 1``
and ``TypeOfTimestepCriterion 4``) on cosmo-sidm's field with its uniform
part moving (tests/make_torch_golden.py ``cvd_config``, N = 512, mesh 32)
on the phased step (``p``) and on the single-program step (``s``), prepare
+ CSIDM["steps"] steps, held to JAX's states frozen in
tests/data/torch_cosmo_sidm_golden.npz (``v{p,s}{k}_``). The pass keeps
JAX's 96 rows a bucket and 10 levels (``Simulation.HASH_CAP_GROWTH =
False``, ROADMAP C.13, C.16), the list monitor JAX's plain displacement
(``LIST_MONITOR_IMAGE = False``, C.20).

Held after every step: the neighbour counts ``ngb_vd`` equal; ``hsml_vd``
within 1e-6 relative (JAX's XLA contracts r^2 into FMAs on this CPU: one
ULP, ROADMAP C.16); ``dens_vd`` and ``vel_disp`` within 1e-5 of their
largest (float64 sums of those radii's kernel weights, in another order);
time and timesteps, which criterion 4 takes from those sums, to rtol
1e-5; positions to 1e-6 of the box; velocities and accelerations to 2e-3
of their largest magnitude (tests/torch_cosmo_checks.py's TreePM bar).
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.flagship import COSMO_FIELD_SIGMA
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import (COSMO_SIDM_GOLDEN, CSIDM, CVD_MODES,
                                     csidm_field, cvd_config)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    with np.load(COSMO_SIDM_GOLDEN) as z:
        return {k: z[k] for k in z.files if k.startswith("v")}


@pytest.mark.parametrize("tag", list(CVD_MODES))
def test_veldisp_in_the_box_matches_jax(tmp_path, golden, tag):
    sim = Simulation(SimConfig(**cvd_config(OutputDir=str(tmp_path))),
                     mode=CVD_MODES[tag], device="cpu")
    sim.HASH_CAP_GROWTH = False
    sim.LIST_MONITOR_IMAGE = False
    n = CSIDM["n"]
    pos, vel, mass = csidm_field(COSMO_FIELD_SIGMA)
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(n, np.int32))
    sim.prepare()
    box = sim.cfg.BoxSize
    kinds = []
    for k in range(CSIDM["steps"] + 1):
        if k:
            sim.step()
            kinds.append((sim.last_list_info or {}).get("kind"))
        pre = f"v{tag}{k}_"
        p = sim.particles
        t = float(golden[pre + "time"])
        assert abs(sim.time - t) <= 1e-5 * t, (pre, sim.time, t)
        np.testing.assert_allclose(p.max_pred_time.numpy(),
                                   golden[pre + "max_pred_time"], rtol=1e-5)
        d = np.abs(p.pos.numpy() - golden[pre + "pos"])
        assert np.minimum(d, box - d).max() <= 1e-6 * box, pre
        np.testing.assert_array_equal(p.ngb_vd.numpy(),
                                      golden[pre + "ngb_vd"], pre)
        np.testing.assert_allclose(p.hsml_vd.numpy(),
                                   golden[pre + "hsml_vd"], rtol=1e-6)
        for f, tol in (("dens_vd", 1e-5), ("vel_disp", 1e-5), ("vel", 2e-3),
                       ("accel", 2e-3)):
            want = golden[pre + f]
            err = np.abs(getattr(p, f).numpy() - want).max()
            assert err <= tol * np.abs(want).max(), (pre, f, err)
        info = sim.last_veldisp_info
        assert int(info["queries"]) > 0 and info["levels"] == 10, info
    if tag == "p":
        assert "record" in kinds and "list" in kinds, kinds
