"""Individual timesteps (``Simulation(mode="individual")``) and the
velocity-dispersion pass (``VelDispOn 1``) on the port's single-program
step, against the JAX ``Simulation`` on the inputs of JAX's own tests
(tests/test_simulation_features.py), with JAX's runs frozen in
tests/data/torch_veldisp_golden.npz (``python -m tests.make_torch_golden
veldisp``; the ``slow`` test reruns them):

* ``test_individual_timestep_mode_conserves_energy``'s 192-particle
  Plummer sphere (``ForceMethod direct``), step by step from JAX's state
  before each of its first 40 steps: the next step's active set (the
  particles whose new next kick time is the earliest) equal to JAX's
  except at near-ties (particles whose JAX kick times lie within 1e-6
  relative of the earliest: counted), the state to 1e-5 of each array's
  largest magnitude and the kick times to 1e-6; then JAX's own loop and
  energy bar (|dE/E| < 0.05, some steps partial);
* ``test_veldisp_and_criterion_4``'s input (256 particles, criterion 4,
  synchronized) prepare + 3 steps at JAX's fixed cap of 96 rows a bucket
  (which drops rows here: counted): ngb_vd equal, hsml_vd, dens_vd,
  vel_disp and kick times to 1e-5 relative, positions and velocities to
  1e-5 of their largest magnitude, and JAX's own asserts; with the cap
  grown (the default) nothing drops;
* the hash DSMC engine in individual mode (512 Plummer particles, 24
  steps; at JAX's fixed cap of 96): active and scatter counts equal, the
  scatter log's partners equal and its kicks to 1e-5, every step's kicks
  conserving momentum, steps that gate no target among them;
* a restart written mid-run in individual mode with ``VelDispOn`` and
  resumed equals the uninterrupted run bit for bit;
* the modes: an unknown mode raises ``ValueError``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.diagnostics import compute_system_state
from sidm_tpu_torch.io import ics
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import (HIND, HIND_CONFIG, HIND_FIELDS, IND,
                                     IND_CONFIG, IND_FIELDS, VD4, VD4_CONFIG,
                                     VELDISP_GOLDEN, jax_individual_runs,
                                     plummer)

torch.set_num_threads(2)

NEAR_TIE = 1e-6


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(VELDISP_GOLDEN))


def _sim(config, mode, spec, **changes):
    sim = Simulation(SimConfig(**{**config, **changes}), mode=mode,
                     device="cpu")
    sim.set_particles_from_arrays(*plummer(ics, spec["n"], spec["seed"]),
                                  pad_to_multiple=spec.get("pad", spec["n"]))
    return sim


def _energy(sim) -> float:
    s = compute_system_state(sim.particles)
    return float(s.energy_kin + s.energy_pot)


def _max_err(a, b) -> float:
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(np.asarray(a, np.float64) - b))
                 / max(np.max(np.abs(b)), 1e-30))


def _earliest(mpt):
    return mpt == mpt.min()


def test_individual_steps_match_jax(golden):
    sim = _sim(IND_CONFIG, "individual", IND)
    sim.prepare()
    mismatched, ties, partial = 0, 0, 0
    for k in range(IND["steps"]):
        sim.particles = dataclasses.replace(sim.particles, **{
            f: torch.as_tensor(golden[f"ind{k}_{f}"]) for f in IND_FIELDS})
        sim.time = float(golden[f"ind{k}_time"])
        _, n_act, _ = sim.step()
        partial += n_act < IND["n"]
        want = {f: golden[f"ind{k + 1}_{f}"] for f in IND_FIELDS}
        got = {f: getattr(sim.particles, f).numpy() for f in IND_FIELDS}
        assert sim.time == pytest.approx(float(golden[f"ind{k + 1}_time"]),
                                         rel=1e-6)
        for f in ("pos", "vel", "accel", "old_acc"):
            assert _max_err(got[f], want[f]) <= 1e-5, (k, f)
        for f in ("current_time", "max_pred_time"):
            np.testing.assert_allclose(got[f], want[f], rtol=1e-6)
        a_got = _earliest(got["max_pred_time"])
        a_want = _earliest(want["max_pred_time"])
        if not np.array_equal(a_got, a_want):
            mismatched += 1
            t = want["max_pred_time"].min()
            diff = a_got ^ a_want
            ties += bool(np.all(np.abs(want["max_pred_time"][diff] - t)
                                <= NEAR_TIE * t))
    print(f"{IND['steps']} steps: {partial} partial, next active sets "
          f"differing {mismatched} (near-ties {ties})")
    assert mismatched == ties and partial > 0


def test_individual_run_conserves_energy(golden):
    """JAX's test loop and bar; the active counts equal to JAX's run's."""
    sim = _sim(IND_CONFIG, "individual", IND)
    sim.prepare()
    sim.compute_potential()
    e0 = _energy(sim)
    nact = []
    for _ in range(IND["max_steps"]):
        if sim.time >= IND["t_end"]:
            break
        nact.append(sim.step()[1])
    sim.compute_potential()
    de = abs(_energy(sim) - e0) / abs(e0)
    want = golden["ind_nact"]
    same = next((i for i, (a, b) in enumerate(zip(nact, want)) if a != b),
                min(len(nact), len(want)))
    print(f"{len(nact)} steps (JAX {len(want)}), t = {sim.time:.6g}, |dE/E| "
          f"{de:.3e} (JAX {abs(golden['ind_e1'] / golden['ind_e0'] - 1):.3e}),"
          f" active counts as JAX's for {same} steps")
    assert min(nact) < IND["n"] and de < 0.05
    assert same >= IND["steps"]


def test_veldisp_criterion_4_matches_jax(golden):
    sim = _sim(VD4_CONFIG, "synchronized", VD4)
    sim.HASH_CAP_GROWTH = False
    sim.prepare()
    drops = []
    for k in range(VD4["steps"] + 1):
        if k:
            sim.step()
        p = sim.particles
        assert sim.time == pytest.approx(float(golden[f"vd4_{k}_time"]),
                                         rel=1e-6)
        np.testing.assert_array_equal(p.ngb_vd.numpy(),
                                      golden[f"vd4_{k}_ngb_vd"])
        for f in ("pos", "vel"):
            assert _max_err(getattr(p, f), golden[f"vd4_{k}_{f}"]) <= 1e-5
        for f in ("max_pred_time", "hsml_vd", "dens_vd", "vel_disp"):
            np.testing.assert_allclose(getattr(p, f).numpy(),
                                       golden[f"vd4_{k}_{f}"], rtol=1e-5,
                                       err_msg=f"{k} {f}")
        drops.append(sim.last_veldisp_info["ngb_ovf"])
    print(f"queries past JAX's cap of 96 a pass: {drops}")
    assert drops[0] > 0     # JAX's drops, counted
    # JAX's own asserts (test_simulation_features.py:134-142)
    n = VD4["n"]
    vd, rho = p.vel_disp.numpy()[:n], p.dens_vd.numpy()[:n]
    assert (vd > 0).all() and np.isfinite(vd).all()
    assert (rho > 0).all() and np.isfinite(rho).all()
    r = np.linalg.norm(plummer(ics, n, VD4["seed"])[0], axis=1)
    inner, outer = r < np.percentile(r, 20), r > np.percentile(r, 80)
    assert rho[inner].mean() > 5 * rho[outer].mean() and sim.time > 0


def test_veldisp_grown_cap_drops_nothing(golden):
    """With growth (the default) the pass reads every row: none dropped,
    the counts at least JAX's truncated ones, its density estimates
    differing from JAX's where JAX truncated."""
    sim = _sim(VD4_CONFIG, "synchronized", VD4)
    sim.prepare()
    info, p = sim.last_veldisp_info, sim.particles
    ngb, want = p.ngb_vd.numpy(), golden["vd4_0_ngb_vd"]
    err = np.abs(p.dens_vd.numpy() / golden["vd4_0_dens_vd"] - 1.0)
    print(f"grown cap {info['cap']} (need {info['need']}), dens_vd against "
          f"JAX's at cap 96: max rel diff {err.max():.3g}, above 1e-3 for "
          f"{int(np.sum(err > 1e-3))} of {VD4['n']}")
    assert info["ngb_ovf"] == 0 and info["lvl_clip"] == 0
    assert info["cap"] > 96 and np.all(ngb >= want - 1)


def test_hash_dsmc_individual_matches_jax(golden, tmp_path):
    sim = _sim(HIND_CONFIG, "individual", HIND, OutputDir=str(tmp_path))
    sim.HASH_CAP_GROWTH = False
    sim.prepare()
    nact, scat, gated = [], [], []
    for k in range(1, HIND["steps"] + 1):
        _, n_act, n_scat = sim.step()
        si = sim.last_sidm_info
        nact.append(n_act)
        scat.append(n_scat)
        gated.append(si["n_gated"])
        m = sim.particles.mass[:, None].double()
        kick = si["kick"].double()
        tot = float(torch.sum(m * torch.linalg.norm(kick, dim=1,
                                                    keepdim=True)))
        assert float(torch.linalg.norm(torch.sum(m * kick, 0))) <= 1e-5 * tot
        for f in HIND_FIELDS:
            assert _max_err(getattr(sim.particles, f),
                            golden[f"hind{k}_{f}"]) <= 1e-5, (k, f)
    want_act = [int(golden[f"hind{k}_nact"]) for k in range(1, HIND["steps"]
                                                             + 1)]
    want_scat = [int(golden[f"hind{k}_n_scat"])
                 for k in range(1, HIND["steps"] + 1)]
    print(f"active {nact}, scatters {scat}, gated {gated}")
    assert nact == want_act and scat == want_scat
    assert min(nact) < HIND["n"] and sum(scat) > 0 and 0 in gated
    got = np.fromfile(os.path.join(tmp_path, "sct_000.0"),
                      np.float32).reshape(-1, 20)
    want = golden["hind_sct"]
    np.testing.assert_array_equal(got[:, 1:3].view(np.int32),
                                  want[:, 1:3].view(np.int32))
    assert _max_err(got[:, 17:20], want[:, 17:20]) <= 1e-5


def test_individual_restart_resumes_bit_equal(tmp_path):
    """A restart written mid-run in individual mode with VelDispOn, resumed
    by a new Simulation, goes on as the uninterrupted run, bit for bit."""
    cfg = dict(VD4_CONFIG, OutputDir=str(tmp_path))
    a = _sim(cfg, "individual", VD4)
    a.prepare()
    for _ in range(4):
        a.step()
    a.write_restart_file()
    for _ in range(4):
        a.step()
    b = Simulation(SimConfig(**cfg), restart_flag=1, mode="individual",
                   device="cpu")
    b.load_restart_file()
    for _ in range(4):
        b.step()
    assert (b.time, b.step_count, b.vmax) == (a.time, a.step_count, a.vmax)
    for f in dataclasses.fields(a.particles):
        assert torch.equal(getattr(a.particles, f.name),
                           getattr(b.particles, f.name)), f.name


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        Simulation(SimConfig(**IND_CONFIG), mode="adaptive", device="cpu")


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """This file's part of the committed golden file is what the JAX
    package gives now."""
    live = jax_individual_runs()
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
