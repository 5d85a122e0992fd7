"""cosmo-ewald's steps in the port (``PMGrid -1``: the per-pair Ewald walk
on both steps), on the CPU, against the JAX package's states frozen in
tests/data/torch_ewald_walk_golden.npz (``r``; tests/make_torch_golden.py
``ewald_walk``): cosmo-box with ``PMGrid -1`` on cosmo-sidm's field at
N = CSIDM["n"], at the all-open opening (the relative criterion with
ErrTolForceAcc 0: the geometric test at theta 1e-6, so neither the port's
wq walk nor JAX's treeforce walk accepts a far node and both are the Ewald
direct sum), prepare + 3 steps and ``compute_potential``:

* on the single-program step (``s``) and the phased step (``p``, a fresh
  tree walked every step): the scale factor and the timesteps to rtol
  1e-6, positions to 1e-6 of the box, accelerations and the potential
  (JAX's convention: the lattice self energy psi(0) m kept) to 2e-4 of
  their largest;
* on the phased step with DSMC (``d``: cosmo-sidm-walk's settings, the
  walk engine on the Ewald step's tree; JAX's on ``TreeWalkEngine
  fused``, ROADMAP.md C.9): the same bars, the first step's scatter
  partners bit-equal (its scatter log's events), and every later step's
  scatter count JAX's (its partners may differ: the two walks sum the same
  pairs in another order, so the trajectories differ in the last bits);

and one run through the command line (``cli.main``) of a periodic
parameter file with ``PMGrid -1`` on the single-program step.
"""

import os

import numpy as np
import pytest
import torch

from sidm_tpu_torch import cli
from sidm_tpu_torch import simulation as simmod
from sidm_tpu_torch.config import SimConfig, write_parameters_out
from sidm_tpu_torch.flagship import cosmo_config, cosmo_ics
from sidm_tpu_torch.io.gadget import GadgetHeader, Snapshot, write_snapshot
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import (CSIDM, EWALD_MODES, EWALD_RUN,
                                     EWALD_WALK_GOLDEN, csidm_field,
                                     ewald_config)
from tests.torch_cosmo_dsmc_checks import events

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    with np.load(EWALD_WALK_GOLDEN) as z:
        return {k: z[k] for k in z.files if k.startswith("r")}


def check(sim, golden, pre, pot=False):
    p = sim.particles
    t = float(golden[pre + "time"])
    assert abs(sim.time - t) <= 1e-6 * abs(t), (pre, sim.time, t)
    np.testing.assert_allclose(p.max_pred_time.numpy(),
                               golden[pre + "max_pred_time"], rtol=1e-6)
    box = sim.cfg.BoxSize
    d = np.abs(p.pos.numpy() - golden[pre + "pos"])
    assert np.minimum(d, box - d).max() <= 1e-6 * box, pre
    for f in ("accel",) + (("pot",) if pot else ()):
        want = golden[pre + f]
        err = np.abs(getattr(p, f).numpy() - want).max()
        assert err <= 2e-4 * np.abs(want).max(), (pre, f, err)


@pytest.mark.parametrize("tag", ["s", "p", "d"])
def test_ewald_run_matches_jax(tmp_path, golden, tag):
    mode, _ = EWALD_MODES[tag]
    cfg = SimConfig(**ewald_config(tag, OutputDir=str(tmp_path),
                                   TreeWalkEngine="wq"))
    sim = Simulation(cfg, mode=mode, device="cpu")
    n = CSIDM["n"]
    pos, vel, mass = csidm_field()
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(n, np.int32))
    assert sim._use_ewald_walk() and not sim._use_treepm()
    assert sim._use_phased() == (mode == "phased")
    sim.prepare()
    check(sim, golden, f"r{tag}0_")
    counts = []
    for k in range(1, EWALD_RUN["steps"] + 1):
        _, _, n_scat = sim.step()
        check(sim, golden, f"r{tag}{k}_")
        assert sim.last_step_rebuilt
        wi = sim.last_walk_info
        assert sum(int(wi[f]) for f in ("ovf_open", "ovf_big",
                                        "ovf_items")) == 0
        if tag == "d":
            assert sim.last_sidm_info["engine"] == "walk"
            assert n_scat == int(golden[f"r{tag}{k}_n_scat"]), k
            counts.append(n_scat)
    sim.compute_potential()
    check(sim, golden, f"r{tag}p_", pot=True)
    if tag != "d":
        return
    assert counts[0] > 0
    sct = np.fromfile(os.path.join(str(tmp_path), "sct_000.0"),
                      np.float32).reshape(-1, 20)
    want = golden["rd_sct"]
    assert len(sct) == len(want) == sum(counts)
    first = counts[0]
    assert events(sct[:first]) == events(want[:first])


def test_ewald_cli_runs(tmp_path, monkeypatch):
    """``python -m sidm_tpu_torch`` with a periodic comoving parameter file
    and ``PMGrid -1``: the run ends at TimeMax, every force on the Ewald
    walk (the single-program step at this N)."""
    n = 256
    pos, vel, mass = cosmo_ics(n, 9)
    npart = np.zeros(6, np.int32)
    npart[1] = n
    base = cosmo_config(n, PMGrid=-1)
    ic = str(tmp_path / "ic")
    write_snapshot(ic, Snapshot(
        header=GadgetHeader(npart=npart, npart_total=npart.copy(),
                            time=base.TimeBegin, box_size=base.BoxSize,
                            omega0=base.Omega0,
                            omega_lambda=base.OmegaLambda,
                            hubble_param=base.HubbleParam),
        pos=pos.astype(np.float32), vel=vel.astype(np.float32),
        pid=np.arange(1, n + 1, dtype=np.uint32),
        mass=mass.astype(np.float32), ptype=np.ones(n, np.int32)))
    out = str(tmp_path / "out") + "/"
    os.makedirs(out)
    cfg = cosmo_config(n, PMGrid=-1, OutputDir=out, InitCondFile=ic,
                       TimeMax=0.1005, TimeBetStatistics=0.001,
                       TimeOfFirstSnapshot=0.1, TimeBetSnapshot=1.003,
                       ResubmitCommand="none", OutputListFilename="none")
    path = str(tmp_path / "param.txt")
    os.replace(write_parameters_out(cfg, str(tmp_path)), path)
    tables = []
    real = simmod.wq_gravity

    def spy(*a, **kw):
        tables.append(kw.get("ewald"))
        return real(*a, **kw)

    monkeypatch.setattr(simmod, "wq_gravity", spy)
    assert cli.main([path], device="cpu") == 0
    with open(os.path.join(out, "info_out")) as f:
        steps = [line for line in f if line.startswith("Begin Step")]
    assert len(steps) >= 2 and len(tables) > len(steps)
    assert all(t is not None and t.box == cfg.BoxSize for t in tables)
    with open(os.path.join(out, "energy_out")) as f:
        rows = [[float(v) for v in line.split()] for line in f]
    assert rows and np.isfinite(rows).all()
