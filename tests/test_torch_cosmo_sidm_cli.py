"""A comoving SIDM run in a periodic box through the port's command line
(``cli.main``, on the CPU): cosmo-sidm (``flagship.COSMO_SIDM``, its
cross section raised 1e4x as in tests/make_torch_golden.py ``CSIDM``) at
N = 256 with mesh 32 from a Gadget IC of its field (``cosmo_ics(a_vel=)``),
on the single-program step (the hash DSMC engine in the box), with
``ScatterLog 1``.

Restart flag 0 runs to a scale factor A_MID and writes its restart file;
its scatter log holds every scatter with its scale factor and the two
particles' ids. The restart file holds what the same run gives through
``Simulation`` (load_ic, prepare and as many steps) bit for bit, and a
``Simulation`` resumed from it (``load_restart_file``) steps on as the
uninterrupted run does, bit for bit. Flag 1 resumes the file to A_END,
and flag 2 starts from the first run's last snapshot at its scale factor.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from sidm_tpu_torch import cli
from sidm_tpu_torch.config import parse_parameter_file, write_parameters_out
from sidm_tpu_torch.flagship import COSMO_SIDM, cosmo_config, cosmo_ics
from sidm_tpu_torch.io.checkpoint import read_restart
from sidm_tpu_torch.io.gadget import (GadgetHeader, Snapshot, read_snapshot,
                                      write_snapshot)
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import CSIDM

torch.set_num_threads(2)

N = 256
A_MID = 0.1005
A_END = 0.1009


def config(**changes):
    return cosmo_config(N, **{
        **COSMO_SIDM, "PMGrid": CSIDM["mesh"], "CrossSection": CSIDM["cs"],
        "ScatterLog": 1, "TimeBetStatistics": 0.001,
        "ResubmitCommand": "none", "OutputListFilename": "none",
        "TimeOfFirstSnapshot": 0.1, "TimeBetSnapshot": 1.0003, **changes})


def param_file(path, **changes) -> str:
    out = write_parameters_out(config(**changes), os.path.dirname(path))
    os.replace(out, path)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cosmo_sidm_cli")
    pos, vel, mass = cosmo_ics(N, CSIDM["seed"], a_vel=CSIDM["a_vel"])
    npart = np.zeros(6, np.int32)
    npart[1] = N
    cfg = config()
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
    p0 = param_file(str(tmp / "p0.txt"), OutputDir=d0, InitCondFile=ic,
                    TimeMax=A_MID)
    rc = {0: cli.main([p0], device="cpu")}
    mid = str(tmp / "mid") + "/"
    os.makedirs(mid)
    shutil.copy(os.path.join(d0, "rst_out.npz"), mid)
    rst = read_restart(os.path.join(mid, "rst_out.npz"), device="cpu")
    sct = np.concatenate([np.fromfile(os.path.join(d0, f), np.float32)
                          for f in sorted(os.listdir(d0))
                          if f.startswith("sct_")]).reshape(-1, 20)
    snaps = sorted(n for n in os.listdir(d0) if n.startswith("snp_"))
    last = str(tmp / "last")
    write_snapshot(last, read_snapshot(os.path.join(d0, snaps[-1])))
    rc[1] = cli.main([param_file(str(tmp / "p1.txt"), OutputDir=d0,
                                 InitCondFile=ic, TimeMax=A_END), "1"],
                     device="cpu")
    open(os.path.join(d2, "stop"), "w").close()
    rc[2] = cli.main([param_file(str(tmp / "p2.txt"), OutputDir=d2,
                                 InitCondFile=last, TimeMax=A_END), "2"],
                     device="cpu")
    return dict(rc=rc, d0=d0, d2=d2, mid=mid, p0=p0, rst=rst, sct=sct,
                last=last)


def test_flag0_scatters_and_logs_in_the_scale_factor(runs):
    assert runs["rc"][0] == 0
    _, rv = runs["rst"]
    assert rv["time"] == pytest.approx(A_MID, rel=1e-6)
    sct = runs["sct"]
    ids = sct[:, 1:3].view(np.int32)
    assert len(sct) > 0
    assert np.all((ids >= 1) & (ids <= N)) and np.all(ids[:, 0] != ids[:, 1])
    assert np.all((sct[:, 0] > 0.1) & (sct[:, 0] <= np.float32(A_MID)))


def test_restart_resumes_bit_equal(runs):
    p_rst, rv = runs["rst"]
    cfg = parse_parameter_file(runs["p0"]).replace(ScatterLog=0)
    a = Simulation(cfg, device="cpu")
    a.load_ic()
    a.prepare()
    for _ in range(rv["step_count"]):
        a.step()
    assert a.time == rv["time"]
    for f, v in dataclasses.asdict(a.particles).items():
        if torch.is_tensor(v):
            assert torch.equal(v, getattr(p_rst, f)), f
    a.cfg = cfg = cfg.replace(TimeMax=A_END)
    b = Simulation(cfg.replace(OutputDir=runs["mid"]), restart_flag=1,
                   device="cpu")
    b.load_restart_file()
    assert b.time == rv["time"] and b.step_count == rv["step_count"]
    for _ in range(2):
        a.step()
        b.step()
    assert b.time == a.time > rv["time"]
    for f, v in dataclasses.asdict(b.particles).items():
        if torch.is_tensor(v):
            assert torch.equal(v, getattr(a.particles, f)), f


def test_flags_1_and_2_resume_in_the_scale_factor(runs):
    assert runs["rc"][1] == 0 and runs["rc"][2] == 0
    _, rv = read_restart(os.path.join(runs["d0"], "rst_out.npz"),
                         device="cpu")
    assert rv["time"] == pytest.approx(A_END, rel=1e-6)
    first = read_snapshot(os.path.join(runs["d2"], "snp_000"))
    assert first.header.time == read_snapshot(runs["last"]).header.time
