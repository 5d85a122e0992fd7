"""Individual timesteps on the port's phased step, against the JAX
``Simulation`` with its run frozen in tests/data/torch_veldisp_golden.npz
(``python -m tests.make_torch_golden veldisp``; the ``slow`` test of
tests/test_torch_individual.py reruns it): flagship-veldisp (``flagship_config(**VELDISP)``:
the cached lists, criterion 4) at N = 4096 in ``mode="individual"`` on the
phased step (``PHASE_THRESHOLD`` 0, as the JAX run set it on its instance),
prepare + 6 steps at JAX's fixed cap of 96 rows a bucket: each step's
active set equal to JAX's (the particles whose kick time is the earliest)
except at near-ties (counted; none here), the inactive particles' state
unchanged bit for bit by every step, the end state as JAX's.
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import (PIND, PIND_CONFIG, SEED,
                                     VELDISP_GOLDEN, flagship_ics)

torch.set_num_threads(2)

NEAR_TIE = 1e-6
KEPT = ("pos", "vel", "current_time", "max_pred_time", "hsml_vd", "ngb_vd",
        "vel_disp", "dens_vd")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(VELDISP_GOLDEN))


def test_phased_individual_flagship_veldisp(golden):
    pos, vel, mass = flagship_ics(PIND["n"], SEED)
    sim = Simulation(SimConfig(**PIND_CONFIG), mode="individual",
                     device="cpu")
    sim.PHASE_THRESHOLD = 0
    sim.HASH_CAP_GROWTH = False
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(PIND["n"],
                                                          np.int32))
    sim.prepare()
    assert sim._use_phased()
    ties, kinds, nact = 0, [], []
    for k in range(1, PIND["steps"] + 1):
        before = {f: getattr(sim.particles, f).clone() for f in KEPT}
        mpt_jax = golden[f"pind{k - 1}_max_pred_time"]
        want = mpt_jax == mpt_jax.min()
        got = (before["max_pred_time"] == before["max_pred_time"].min()
               ).numpy()
        if not np.array_equal(got, want):
            t = mpt_jax.min()
            diff = got ^ want
            assert np.all(np.abs(mpt_jax[diff] - t) <= NEAR_TIE * t), k
            ties += 1
            break
        _, n_act, _ = sim.step()
        nact.append(n_act)
        kinds.append(sim.last_list_info["kind"])
        assert n_act == int(golden[f"pind{k}_nact"]) == int(want.sum())
        inactive = torch.as_tensor(~want)
        for f in KEPT:
            assert torch.equal(getattr(sim.particles, f)[inactive],
                               before[f][inactive]), (k, f)
        assert sim.last_veldisp_info["queries"] == n_act
    print(f"active {nact}, step kinds {kinds}, near-ties {ties}, veldisp "
          f"{sim.last_veldisp_info}")
    assert ties == 0 and max(nact) < PIND["n"]
    p = sim.particles
    for f in ("pos", "vel", "hsml_vd", "dens_vd", "vel_disp",
              "current_time", "max_pred_time"):
        np.testing.assert_allclose(getattr(p, f).numpy(),
                                   golden[f"pind_{f}"], rtol=1e-5,
                                   atol=1e-6 * float(np.abs(
                                       golden[f"pind_{f}"]).max()),
                                   err_msg=f)
    np.testing.assert_array_equal(p.ngb_vd.numpy(), golden["pind_ngb_vd"])
