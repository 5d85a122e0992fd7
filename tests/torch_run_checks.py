"""Comparisons of the port's run-loop outputs with the JAX run's frozen in
tests/data/torch_run_golden.npz, shared by tests/test_torch_run.py (the
first run, ``a``) and tests/test_torch_run_resume.py (the resume, ``b``).

Held: the set of output files equal; the info log's step numbers and
particle counts exactly and its ``%g`` times and timesteps to one unit in
their sixth significant digit (the slice tests hold times to rtol 1e-6: a
float32 time one ULP apart can print another sixth digit); the energy
log's 24 columns to rtol 1e-6 for time and to 1e-4 of each column's
largest magnitude; the snapshots' ids, types and masses exactly, positions
and velocities to 1e-4 of their largest magnitude; the scatter log's
record count per file exactly and its id pairs exactly (allowance: 0
differing pairs; the slice tests allow no near-tie at this size either),
its floats to 1e-4 of each column group's largest magnitude; the CPU and
timings logs one entry per step; the restart file's state to 1e-4 of each
array's magnitude, its integers, step and snapshot counts exactly and its
times and vmax to rtol 1e-6.
"""

import os
import re

import numpy as np

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.io.checkpoint import read_restart, read_scatter_log
from sidm_tpu_torch.io.gadget import (GadgetHeader, Snapshot, read_snapshot,
                                      write_snapshot)
from sidm_tpu_torch.simulation import Simulation
from sidm_tpu_torch.state import state_dict
from tests.make_torch_golden import (RESUME_STEPS, RUN_CONFIG, RUN_GOLDEN,
                                     RUN_STEPS, output_files, run_ic)

TOL = 1e-4          # of each array's (column's) largest magnitude
STEPS = dict(a=RUN_STEPS, b=RUN_STEPS + RESUME_STEPS)


def load_golden():
    return dict(np.load(RUN_GOLDEN))


def golden_files(golden, tag):
    pre = f"{tag}_file_"
    return {k[len(pre):]: golden[k].tobytes() for k in golden
            if k.startswith(pre)}


def port_run(tmp, golden, tag):
    """The port's run ``tag`` in directory ``tmp``: ``a`` from the port's
    own IC file, ``b`` resuming in a directory holding JAX's files after
    its ``a`` (its restart file included). Returns (the IC file's bytes,
    the output directory, its files' bytes by name)."""
    ic = os.path.join(tmp, "ic")
    write_snapshot(ic, run_ic(Snapshot, GadgetHeader))
    out = os.path.join(tmp, tag) + "/"
    cfg = SimConfig(**{**RUN_CONFIG, "OutputDir": out, "InitCondFile": ic})
    if tag == "a":
        sim = Simulation(cfg, mode="phased", device="cpu")
        sim.load_ic()
    else:
        os.makedirs(out)
        for name, raw in golden_files(golden, "a").items():
            with open(os.path.join(out, name), "wb") as f:
                f.write(raw)
        sim = Simulation(cfg, restart_flag=1, mode="phased", device="cpu")
        sim.load_restart_file()
    sim.prepare()
    sim.run(max_steps=STEPS[tag])
    sim.close_logs()
    with open(ic, "rb") as f:
        ic_bytes = f.read()
    files = {k[len("file_"):]: v.tobytes()
             for k, v in output_files(out, "").items()}
    return ic_bytes, out, files


def check_files(files, golden, tag):
    want = sorted(golden_files(golden, tag))
    assert sorted(files) == want
    assert {"snp_000", "snp_001", "rst_out.npz", "energy_out", "info_out",
            "cpu_out", "timings_out"} <= set(want)
    assert any(n.startswith("sct_") for n in want)


_INFO = re.compile(r"Begin Step (\d+), Time: (\S+), NumForceUpdate: (\d+), "
                   r"Systemstep: (\S+)")


def check_info(files, golden, tag):
    got = _INFO.findall(files["info_out"].decode())
    want = _INFO.findall(golden_files(golden, tag)["info_out"].decode())
    assert len(got) == len(want) == STEPS[tag]
    assert [(g[0], g[2]) for g in got] == [(w[0], w[2]) for w in want]
    for g, w in zip(got, want):
        for x, y in ((float(g[1]), float(w[1])), (float(g[3]), float(w[3]))):
            # one unit in the sixth significant digit that %g prints
            ulp6 = 10.0 ** (np.floor(np.log10(abs(y))) - 5) if y else 0.0
            assert abs(x - y) <= 1.0001 * ulp6, (g, w)
    assert files["info_out"].count(b"\n") == \
        golden_files(golden, tag)["info_out"].count(b"\n")


def _energy(raw: bytes):
    return np.array([[float(x) for x in line.split()]
                     for line in raw.decode().splitlines()])


def check_energy(files, golden, tag, rows):
    got = _energy(files["energy_out"])
    want = _energy(golden_files(golden, tag)["energy_out"])
    assert got.shape == want.shape == (rows, 24)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6)
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    err = (np.abs(got - want) / scale).max()
    assert err <= TOL, err


def check_snapshots(files, golden, tag, out, tmp):
    gfiles = golden_files(golden, tag)
    names = sorted(n for n in gfiles if n.startswith("snp_"))
    assert names == sorted(n for n in files if n.startswith("snp_"))
    for name in names:
        with open(os.path.join(tmp, name), "wb") as f:
            f.write(gfiles[name])
        want = read_snapshot(os.path.join(tmp, name), use_native=False)
        got = read_snapshot(os.path.join(out, name))
        np.testing.assert_allclose(got.header.time, want.header.time,
                                   rtol=1e-6)
        for f in ("pid", "ptype", "mass"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f), err_msg=f)
        for f in ("pos", "vel"):
            a, b = getattr(got, f), getattr(want, f)
            err = np.abs(a - b).max() / np.abs(b).max()
            assert err <= TOL, (name, f, err)
    return names


def check_scatter_log(files, golden, tag, out, tmp):
    gfiles = golden_files(golden, tag)
    names = sorted(n for n in gfiles if n.startswith("sct_"))
    assert names == sorted(n for n in files if n.startswith("sct_"))
    total, differing = 0, 0
    for name in names:
        with open(os.path.join(tmp, name), "wb") as f:
            f.write(gfiles[name])
        want = read_scatter_log(os.path.join(tmp, name))
        got = read_scatter_log(os.path.join(out, name))
        assert len(got[0]) == len(want[0]), name
        total += len(got[0])
        differing += int(np.sum((got[1] != want[1]) | (got[2] != want[2])))
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        rest_g, rest_w = got[3], want[3]
        # h1 h2, x1 x2, v1 v2, dv: each group to 1e-4 of its magnitude
        for lo, hi in ((0, 2), (2, 8), (8, 14), (14, 17)):
            scale = max(float(np.abs(rest_w[:, lo:hi]).max()), 1e-30)
            err = float(np.abs(rest_g[:, lo:hi] - rest_w[:, lo:hi]).max())
            assert err <= TOL * scale, (name, lo, err, scale)
    print(f"{tag}: {total} scatter records, {differing} differing id pairs")
    assert total > 0
    assert differing == 0
    return total


def check_step_logs(files, golden, tag):
    steps = STEPS[tag]
    for name in ("cpu_out", "timings_out"):
        got = files[name].decode().splitlines()
        want = golden_files(golden, tag)[name].decode().splitlines()
        assert len(got) == len(want) == 2 * steps, name
    cpu = files["cpu_out"].decode().splitlines()
    assert all(len(line.split()) == 15 for line in cpu[1::2])
    assert [line.split(",")[0] for line in cpu[0::2]] == \
        [f"Step {k}" for k in range(1, steps + 1)]


def check_restart(golden, tag, out, tmp):
    with open(os.path.join(tmp, "j.npz"), "wb") as f:
        f.write(golden_files(golden, tag)["rst_out.npz"])
    jp, jrv = read_restart(os.path.join(tmp, "j.npz"), device="cpu")
    tp, trv = read_restart(os.path.join(out, "rst_out.npz"), device="cpu")
    assert sorted(trv) == sorted(jrv)
    for k in ("step_count", "snapshot_count"):
        assert trv[k] == jrv[k], k
    for k in ("time", "time_last_statistics", "time_of_first_snapshot",
              "vmax"):
        np.testing.assert_allclose(trv[k], jrv[k], rtol=1e-6, err_msg=k)
    assert trv["step_count"] == STEPS[tag]
    td, jd = state_dict(tp), state_dict(jp)
    for k in ("pid", "ptype", "mass", "ngb_vd"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    for k in ("pos", "vel", "accel", "hsml_vd", "dvel", "max_pred_time"):
        scale = max(float(np.abs(jd[k]).max()), 1e-30)
        err = float(np.abs(td[k] - jd[k]).max()) / scale
        assert err <= TOL, (k, err)
