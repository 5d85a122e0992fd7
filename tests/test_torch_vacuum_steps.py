"""flagship-vacuum's steps in the port (``Simulation``, ``PMVacuum 1`` on
the phased step), on the CPU, against the JAX package's phased step
frozen in tests/data/torch_vacuum_golden.npz (``vs``; tests/
make_torch_golden.py ``vacuum``): bench.py's NFW halo at N = VAC["n"] on
the cached lists (``l``: records and list steps, the drift-mode lists on
``advance_tree``) and on the walk (``w``), prepare + 3 steps; and one run
through the command line (``cli.main``).

Held after every step: the time and the timesteps (``max_pred_time``) to
rtol 1e-6, positions to 1e-6 of the halo's extent, accelerations to 2e-4
of their largest (the screened pairs' erf, erfc and exp and the mesh's
FFTs in torch and in XLA, summed in other orders); the free-space mesh of
the run equal to JAX's (PMGrid 0: 64 at this N, its region the
reflection sphere x 1.02); the mesh's phase (``pm``) in every step's
walls; no list or walk overflow.
"""

import os

import numpy as np
import pytest
import torch

from sidm_tpu_torch import cli
from sidm_tpu_torch import simulation as simmod
from sidm_tpu_torch.config import SimConfig, write_parameters_out
from sidm_tpu_torch.flagship import flagship_ics
from sidm_tpu_torch.io.gadget import GadgetHeader, Snapshot, write_snapshot
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import VAC, VACUUM_GOLDEN, vacuum_config

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    with np.load(VACUUM_GOLDEN) as z:
        return {k: z[k] for k in z.files if k.startswith("vs")}


def check(sim, golden, pre, extent):
    p = sim.particles
    t = float(golden[pre + "time"])
    assert abs(sim.time - t) <= 1e-6 * max(abs(t), 1e-30), (pre, sim.time)
    np.testing.assert_allclose(p.max_pred_time.numpy(),
                               golden[pre + "max_pred_time"], rtol=1e-6)
    d = np.abs(p.pos.numpy() - golden[pre + "pos"]).max()
    assert d <= 1e-6 * extent, (pre, d)
    want = golden[pre + "accel"]
    err = np.abs(p.accel.numpy() - want).max()
    assert err <= 2e-4 * np.abs(want).max(), (pre, err)


@pytest.mark.parametrize("mode", ["l", "w"])
def test_vacuum_phased_matches_jax(golden, mode):
    n = VAC["n"]
    pos, vel, mass = flagship_ics(n, VAC["seed"])
    extent = float(np.ptp(pos, axis=0).max())
    sim = Simulation(SimConfig(**vacuum_config(mode)), mode="phased",
                     device="cpu")
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(n, np.int32))
    assert sim._use_vacuum_pm() and sim._pbc() is None
    sim.prepare()
    check(sim, golden, f"vs{mode}0_", extent)
    kern = sim._pm_kernel_free()
    assert np.allclose([kern.n, kern.alpha, kern.rcut, kern.box],
                       golden[f"vs{mode}_mesh"], rtol=1e-12)
    kinds = []
    for k in range(1, VAC["steps"] + 1):
        sim.step()
        check(sim, golden, f"vs{mode}{k}_", extent)
        assert "pm" in sim.last_phase_wall
        if mode == "l":
            li = sim.last_list_info
            kinds.append(li["kind"])
            assert li["ovf"] is None or sum(li["ovf"]) == 0
        else:
            wi = sim.last_walk_info
            assert sum(int(wi[f]) for f in ("ovf_open", "ovf_big",
                                            "ovf_items")) == 0
    if mode == "l":
        assert "list" in kinds and "record" in kinds, kinds


def test_vacuum_cli_runs(tmp_path, monkeypatch):
    """``python -m sidm_tpu_torch`` with ``PMVacuum 1`` on the phased step
    (PHASE_THRESHOLD 0): the run ends at TimeMax with every step's far
    field on the free-space mesh."""
    n = 512
    pos, vel, mass = flagship_ics(n, 7)
    npart = np.zeros(6, np.int32)
    npart[1] = n
    ic = str(tmp_path / "ic")
    write_snapshot(ic, Snapshot(
        header=GadgetHeader(npart=npart, npart_total=npart.copy()),
        pos=pos.astype(np.float32), vel=vel.astype(np.float32),
        pid=np.arange(1, n + 1, dtype=np.uint32),
        mass=mass.astype(np.float32), ptype=np.ones(n, np.int32)))
    out = str(tmp_path / "out") + "/"
    os.makedirs(out)
    cfg = SimConfig(**vacuum_config(
        "l", OutputDir=out, InitCondFile=ic, TimeMax=0.0012,
        TimeBetStatistics=0.001, TimeOfFirstSnapshot=0.0012,
        TimeBetSnapshot=1.0, ResubmitCommand="none",
        OutputListFilename="none"))
    path = str(tmp_path / "param.txt")
    os.replace(write_parameters_out(cfg, str(tmp_path)), path)
    calls = []
    real = simmod.pm_accel_free

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(simmod, "pm_accel_free", counted)
    monkeypatch.setattr(Simulation, "PHASE_THRESHOLD", 0)
    assert cli.main([path], device="cpu") == 0
    with open(os.path.join(out, "info_out")) as f:
        steps = [line for line in f if line.startswith("Begin Step")]
    assert len(steps) >= 2 and len(calls) == len(steps) + 1
    with open(os.path.join(out, "energy_out")) as f:
        rows = [[float(v) for v in line.split()] for line in f]
    assert rows and np.isfinite(rows).all()
