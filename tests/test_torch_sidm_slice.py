"""The port's Simulation in flagship-dsmc's configuration (bench.py's SIDM
settings on the cached lists, ``flagship_config(**DSMC)``) vs the JAX
``Simulation(mode="phased")``: N = 2048 NFW halo, ``CrossSection`` raised
100x so that particles scatter (tests/make_torch_golden.py
``SIDM_SLICE_CONFIG``), prepare + 6 steps.

Prepare sets the smoothing lengths (``tree_hsml_init_fused``) and records
the first candidate lists; every rebuild step records again (after the
density clamp), every step runs the gated DSMC pass, and ``advance``
applies the kicks. The JAX trajectory is frozen in
tests/data/torch_sidm_slice_golden.npz; the ``slow`` test reruns it and
holds the file to it. Held: the scatter count of every step exactly; the
cadence (rebuilt, lists and candidate lists cached, steps since the
rebuild) exactly and the skin to rtol 1e-3, as in
tests/test_torch_list_slice.py; the neighbour counts exactly except at
counted flips where a pair sits at r = h within the smoothing lengths'
ULPs; time and timesteps to rtol 1e-6; pos, vel, accel, pot, hsml_vd and
dvel to a max error of 1e-4 of each array's largest magnitude (the
existing slice tests' bar)."""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.config import ParameterError, SimConfig
from sidm_tpu_torch.diagnostics import compute_system_state
from sidm_tpu_torch.flagship import DSMC, flagship_config, flagship_ics
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import (N, SEED, SIDM_SLICE_CONFIG,
                                     SIDM_SLICE_GOLDEN, SIDM_STEPS,
                                     jax_sidm_trajectory)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def run():
    """The port's snapshots and cadence state, keyed like the golden
    file, and the per-step SIDM info."""
    pos, vel, mass = flagship_ics(N, SEED)
    sim = Simulation(SimConfig(**SIDM_SLICE_CONFIG), mode="phased",
                     device="cpu")
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32))
    out, infos = {}, []

    def state(prefix, n_scat):
        p = sim.particles
        s = compute_system_state(p)
        out[prefix + "time"] = sim.time
        for f in ("pos", "vel", "accel", "max_pred_time", "pot", "hsml_vd",
                  "ngb_vd", "dvel"):
            out[prefix + f] = getattr(p, f).numpy()
        out[prefix + "ekin"] = float(s.energy_kin)
        out[prefix + "epot"] = float(s.energy_pot)
        k = "k" + prefix[1:]
        out[k + "n_scat"] = n_scat
        out[k + "rebuilt"] = sim.last_step_rebuilt
        out[k + "skin"] = sim._skin_now
        out[k + "listed"] = sim._lists_cache is not None
        out[k + "cands"] = sim._sidm_cands is not None
        out[k + "since"] = sim._steps_since_build
        infos.append(dict(sim.last_sidm_info, masses=p.mass.clone()))

    sim.prepare()
    state("s0_", 0)
    for k in range(1, SIDM_STEPS + 1):
        _, _, n_scat = sim.step()
        state(f"s{k}_", n_scat)
    return out, infos


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(SIDM_SLICE_GOLDEN))


def test_scatter_counts_match_jax(run, golden):
    out, infos = run
    got = [out[f"k{k}_n_scat"] for k in range(SIDM_STEPS + 1)]
    want = [int(golden[f"k{k}_n_scat"]) for k in range(SIDM_STEPS + 1)]
    print(f"scatters per step: {got}")
    assert got == want
    assert sum(got) > 0


def test_cadence_matches_jax(run, golden):
    out, infos = run
    records = [i["record"] for i in infos]
    assert records[0] and sum(records) >= 2
    for k in range(SIDM_STEPS + 1):
        p = f"k{k}_"
        for f in ("rebuilt", "listed", "cands", "since"):
            assert out[p + f] == golden[p + f], (k, f)
        np.testing.assert_allclose(out[p + "skin"], golden[p + "skin"],
                                   rtol=1e-3)
    for i in infos:
        assert i["cand_ovf"] == [0, 0] and i["ovf_g"] == [0, 0]


PREFIXES = [f"s{k}_" for k in range(SIDM_STEPS + 1)]


@pytest.mark.parametrize("prefix", PREFIXES)
def test_state_matches_jax(run, golden, prefix):
    out = run[0]
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


def test_kicks_conserve_momentum(run):
    """Each step's kicks (``dvel`` added by the pass, before ``advance``
    applies them): |sum m dv| <= 1e-5 sum m |dv|."""
    for i in run[1]:
        m = i["masses"][:, None].double()
        kick = i["kick"].double()
        tot = float(torch.sum(m * torch.linalg.norm(kick, dim=1,
                                                    keepdim=True)))
        assert float(torch.linalg.norm(torch.sum(m * kick, 0))) <= 1e-5 * tot


@pytest.mark.parametrize("changes, item", [
    (dict(VelDispOn=1), "item 10"), (dict(ComovingIntegrationOn=1),
                                      "item 11")])
def test_refuses_what_is_not_ported(changes, item):
    """VelDispOn is ported (item 10); with SIDMOn it is refused as the
    reference refuses it. DSMC in comoving runs is ported (item 11.4):
    that configuration constructs."""
    cfg = flagship_config(**{**DSMC, **changes})
    if changes.get("VelDispOn"):
        with pytest.raises(ParameterError, match="sidm.c:14-16"):
            Simulation(cfg, mode="phased", device="cpu")
        return
    sim = Simulation(cfg, mode="phased", device="cpu")
    assert sim.cfg.ComovingIntegrationOn and sim.cfg.SIDMOn


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """The committed golden file is what the JAX Simulation gives now."""
    live = jax_sidm_trajectory()
    assert sorted(live) == sorted(golden)
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
