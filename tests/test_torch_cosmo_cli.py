"""The port's command line with a periodic comoving parameter file and a
Gadget IC (``cli.main``, on the CPU): cosmo-box (``flagship.cosmo_config``
at N = 1024, mesh 32) on the single-program step, whose time is the scale
factor. Restart flag 0 from the IC runs to ``TimeMax``, with snapshots at
scale factors a ratio ``TimeBetSnapshot`` apart (their headers hold a and
the redshift 1/a - 1, positions inside the box); flag 1 resumes its
restart file in a with a ``stop`` file present (one step); flag 2 starts
from the first run's last snapshot at the a of its header.
"""

import os

import numpy as np
import pytest
import torch

from sidm_tpu_torch import cli
from sidm_tpu_torch.config import write_parameters_out
from sidm_tpu_torch.flagship import cosmo_config, cosmo_ics
from sidm_tpu_torch.io.checkpoint import read_restart
from sidm_tpu_torch.io.gadget import (GadgetHeader, Snapshot, read_snapshot,
                                      write_snapshot)

torch.set_num_threads(2)

N = 1024
A_END = 0.1005
A_LATER = 0.102


def param_file(path, **changes) -> str:
    cfg = cosmo_config(N, PMGrid=32, TimeBetStatistics=0.001,
                       ResubmitCommand="none", OutputListFilename="none",
                       TimeOfFirstSnapshot=0.1, TimeBetSnapshot=1.003,
                       **changes)
    out = write_parameters_out(cfg, os.path.dirname(path))
    os.replace(out, path)
    return path


def _steps(d):
    with open(os.path.join(d, "info_out")) as f:
        return [line for line in f if line.startswith("Begin Step")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cosmo_cli")
    pos, vel, mass = cosmo_ics(N, 9)
    npart = np.zeros(6, np.int32)
    npart[1] = N
    cfg = cosmo_config(N)
    ic = str(tmp / "ic")
    write_snapshot(ic, Snapshot(
        header=GadgetHeader(npart=npart, npart_total=npart.copy(),
                            time=cfg.TimeBegin, box_size=cfg.BoxSize,
                            omega0=cfg.Omega0,
                            omega_lambda=cfg.OmegaLambda,
                            hubble_param=cfg.HubbleParam),
        pos=pos.astype(np.float32), vel=vel.astype(np.float32),
        pid=np.arange(1, N + 1, dtype=np.uint32),
        mass=mass.astype(np.float32), ptype=np.ones(N, np.int32)))
    d0, d2 = str(tmp / "out0") + "/", str(tmp / "out2") + "/"
    os.makedirs(d0)
    os.makedirs(d2)
    rc = {}
    rc[0] = cli.main([param_file(str(tmp / "p0.txt"), OutputDir=d0,
                                 InitCondFile=ic, TimeMax=A_END)],
                     device="cpu")
    steps0 = len(_steps(d0))
    # the first run's snapshots, before the resume writes its own (it
    # numbers on from the restart file's count, which leaves out the
    # final snapshot, as in JAX: ROADMAP.md C.12)
    snaps0 = [read_snapshot(os.path.join(d0, n)) for n in
              sorted(n for n in os.listdir(d0) if n.startswith("snp_"))]
    last = str(tmp / "last")
    write_snapshot(last, snaps0[-1])
    open(os.path.join(d0, "stop"), "w").close()
    rc[1] = cli.main([param_file(str(tmp / "p1.txt"), OutputDir=d0,
                                 InitCondFile=ic, TimeMax=A_LATER), "1"],
                     device="cpu")
    open(os.path.join(d2, "stop"), "w").close()
    rc[2] = cli.main([param_file(str(tmp / "p2.txt"), OutputDir=d2,
                                 InitCondFile=last, TimeMax=A_LATER), "2"],
                     device="cpu")
    return rc, d0, d2, steps0, snaps0, last


def test_flag0_runs_in_the_scale_factor(runs):
    rc, d0, _, steps0, snaps0, last = runs
    assert rc[0] == 0 and steps0 >= 2
    assert len(snaps0) >= 2
    box = cosmo_config(N).BoxSize
    times = []
    for s in snaps0:
        times.append(float(s.header.time))
        assert s.header.redshift == pytest.approx(1.0 / s.header.time - 1.0,
                                                  rel=1e-6)
        assert s.pos.min() >= 0.0 and s.pos.max() < box
    assert times[0] == pytest.approx(0.1, rel=1e-6)
    assert times[-1] == pytest.approx(A_END, rel=1e-6)
    with open(os.path.join(d0, "energy_out")) as f:
        rows = [line.split() for line in f]
    assert rows and all(np.isfinite([float(v) for v in r]).all()
                        for r in rows)


def test_flag1_resumes_in_the_scale_factor(runs):
    rc, d0, _, steps0, _, _ = runs
    assert rc[1] == 0
    assert len(_steps(d0)) == steps0 + 1
    _, rv = read_restart(os.path.join(d0, "rst_out.npz"), device="cpu")
    assert rv["step_count"] == steps0 + 1
    assert A_END < rv["time"] < A_LATER


def test_flag2_starts_at_the_snapshots_scale_factor(runs):
    rc, _, d2, _, _, last = runs
    assert rc[2] == 0
    steps = _steps(d2)
    assert len(steps) == 1
    first = read_snapshot(os.path.join(d2, "snp_000"))
    assert first.header.time == read_snapshot(last).header.time
    assert float(steps[0].split("Time: ")[1].split(",")[0]) > A_END
