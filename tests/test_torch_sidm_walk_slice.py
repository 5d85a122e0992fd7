"""The port's Simulation with DSMC on the range walk vs the JAX
``Simulation(mode="phased")``, N = 2048 NFW halo, ``CrossSection`` raised
100x as in tests/test_torch_sidm_slice.py, prepare + 4 steps:

* ``w``: flagship-dsmc-walk (``flagship_config(**DSMC, ListMode=0)``,
  tests/make_torch_golden.py ``SIDM_WALK_CONFIG``): the walk every step,
  the DSMC pass on the range walk every step;
* ``x``: flagship-dsmc whose first candidate record overflows tiny caps
  (``SIDM_EXHAUST_CAPS``) with no cap refit left (the port's
  ``SIDM_REFITS = 0``, JAX's ``_sidm_resizes = 3``): the candidate lists
  are given up in prepare's step and the walk engine runs from then on,
  while the force stays on the cached interaction lists.

JAX runs both on ``TreeWalkEngine fused``: its ``wq`` branch picks
``wq_range.sidm_scatter_wq``, which raises ``NameError`` (``_salt_u32`` is
never imported, ROADMAP C.9), where the port runs its walk engine. The
port's gravity walk is the wq walk, which computes the fused walk's pair
sets. The JAX trajectories are frozen in
tests/data/torch_sidm_walk_golden.npz; the ``slow`` test reruns them.
Held as in tests/test_torch_sidm_slice.py: the scatter count of every
step exactly, the neighbour counts exactly, time and timesteps to rtol
1e-6, pos, vel, accel, pot, hsml_vd and dvel to 1e-4 of each array's
largest magnitude; besides, every step's DSMC ran on the walk with no
drop, and the kicks conserve momentum.
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.diagnostics import compute_system_state
from sidm_tpu_torch.ops.list_range import RangeListConfig
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import (N, SEED, SIDM_EXHAUST_CAPS,
                                     SIDM_EXHAUST_CONFIG, SIDM_WALK_CONFIG,
                                     SIDM_WALK_GOLDEN, WALK_STEPS,
                                     flagship_ics,
                                     jax_sidm_walk_trajectories)

torch.set_num_threads(2)

RUNS = {"w": SIDM_WALK_CONFIG, "x": SIDM_EXHAUST_CONFIG}


def _run(tag):
    pos, vel, mass = flagship_ics(N, SEED)
    sim = Simulation(SimConfig(**RUNS[tag]), mode="phased", device="cpu")
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32))
    if tag == "x":
        sim._sidm_rcfg = RangeListConfig(**SIDM_EXHAUST_CAPS)
        sim.SIDM_REFITS = 0
    out, infos = {}, []

    def state(k, n_scat):
        prefix = f"{tag}{k}_"
        p = sim.particles
        s = compute_system_state(p)
        out[prefix + "time"] = sim.time
        for f in ("pos", "vel", "accel", "max_pred_time", "pot", "hsml_vd",
                  "ngb_vd", "dvel"):
            out[prefix + f] = getattr(p, f).numpy()
        out[prefix + "ekin"] = float(s.energy_kin)
        out[prefix + "epot"] = float(s.energy_pot)
        out[prefix + "n_scat"] = n_scat
        infos.append(dict(sim.last_sidm_info, masses=p.mass.clone(),
                          kind=(sim.last_list_info or {}).get("kind")))

    sim.prepare()
    state(0, 0)
    if tag == "x":
        out["x_disabled"] = sim._sidm_lists_disabled
    for k in range(1, WALK_STEPS + 1):
        _, _, n_scat = sim.step()
        state(k, n_scat)
    return out, infos


@pytest.fixture(scope="module")
def runs():
    return {tag: _run(tag) for tag in RUNS}


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(SIDM_WALK_GOLDEN))


@pytest.mark.parametrize("tag", list(RUNS))
def test_scatter_counts_match_jax(runs, golden, tag):
    out, infos = runs[tag]
    got = [out[f"{tag}{k}_n_scat"] for k in range(WALK_STEPS + 1)]
    want = [int(golden[f"{tag}{k}_n_scat"]) for k in range(WALK_STEPS + 1)]
    print(f"{tag}: scatters per step {got}")
    assert got == want
    assert sum(got) > 0


@pytest.mark.parametrize("tag", list(RUNS))
def test_every_step_ran_the_walk_engine(runs, golden, tag):
    """Every step's DSMC ran on the range walk, with no drop; the kicks
    conserve momentum; the exhausted run gave its lists up in prepare as
    JAX does, while its force stays on the interaction lists."""
    out, infos = runs[tag]
    for i in infos:
        assert i["engine"] == "walk" and i["walk_ovf"] == [0, 0, 0], i
        m = i["masses"][:, None].double()
        kick = i["kick"].double()
        tot = float(torch.sum(m * torch.linalg.norm(kick, dim=1,
                                                    keepdim=True)))
        assert float(torch.linalg.norm(torch.sum(m * kick, 0))) <= 1e-5 * tot
    if tag == "x":
        assert out["x_disabled"] and bool(golden["x_disabled"])
        assert infos[0]["record"]
        assert {i["kind"] for i in infos[1:]} >= {"list"}
    else:
        assert all(i["kind"] is None for i in infos)


PREFIXES = [f"{tag}{k}_" for tag in RUNS for k in range(WALK_STEPS + 1)]


@pytest.mark.parametrize("prefix", PREFIXES)
def test_state_matches_jax(runs, golden, prefix):
    out = runs[prefix[0]][0]
    np.testing.assert_allclose(out[prefix + "time"], golden[prefix + "time"],
                               rtol=1e-6)
    np.testing.assert_allclose(out[prefix + "max_pred_time"],
                               golden[prefix + "max_pred_time"], rtol=1e-6)
    for f in ("pos", "vel", "accel", "pot", "hsml_vd", "dvel"):
        scale = max(float(np.abs(golden[prefix + f]).max()), 1e-30)
        err = float(np.abs(out[prefix + f] - golden[prefix + f]).max()) / scale
        assert err <= 1e-4, (f, err)
    flips = int(np.sum(out[prefix + "ngb_vd"] != golden[prefix + "ngb_vd"]))
    print(f"{prefix}: {flips} neighbour-count flips")
    assert flips == 0


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """This file's part of the committed golden file is what the JAX
    Simulation gives now."""
    live = jax_sidm_walk_trajectories()
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
