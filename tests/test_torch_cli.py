"""The port's command line, ``python -m sidm_tpu_torch <parameterfile>
[restartflag]`` (``cli.main``), end to end on the CPU (``device="cpu"``)
on tests/test_torch_run.py's configuration for an N = 512 halo (the
smallest that scatters in the window) with a short ``TimeMax``
(float32-exact, ~2 steps): restart flag 0 from a Gadget IC,
flag 1 resuming its restart file with a ``stop`` file present (one step,
then the restart file), flag 2 from the first run's last snapshot (the
time taken from its header) with a ``TimeLimitCPU`` that its first step
passes 85 % of (the run stops and fires ``ResubmitCommand``).
``Simulation.PHASE_THRESHOLD`` is set to 0, so that the CLI's
``mode="synchronized"`` runs the phased step at this N
(tests/test_torch_small_cli.py runs the CLI on the single-program step).
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

from sidm_tpu_torch import cli
from sidm_tpu_torch.config import SimConfig, write_parameters_out
from sidm_tpu_torch.io.checkpoint import read_restart, read_scatter_log
from sidm_tpu_torch.io.gadget import (GadgetHeader, Snapshot, read_snapshot,
                                      write_snapshot)
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import RUN_CONFIG, run_ic

torch.set_num_threads(2)

N = 512
T_END = 2.0 ** -11      # two steps of the halo
T_LATER = 2.0 ** -8     # flags 1 and 2: beyond their step before the stop


def param_file(path, **changes) -> str:
    """A parameter file of RUN_CONFIG with ``changes`` (the format of
    ``parameters_out``, which the parser reads back)."""
    cfg = SimConfig(**{**RUN_CONFIG, **changes})
    out = write_parameters_out(cfg, os.path.dirname(path))
    os.replace(out, path)
    return path


def _steps(d):
    with open(os.path.join(d, "info_out")) as f:
        return [line for line in f if line.startswith("Begin Step")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(Simulation, "PHASE_THRESHOLD", 0)
    tmp = tmp_path_factory.mktemp("cli")
    ic = str(tmp / "ic")
    write_snapshot(ic, run_ic(Snapshot, GadgetHeader, N))
    d0, d2 = str(tmp / "out0") + "/", str(tmp / "out2") + "/"
    os.makedirs(d0)
    os.makedirs(d2)
    rc = {}
    try:
        p0 = param_file(str(tmp / "p0.txt"), OutputDir=d0, InitCondFile=ic,
                        TimeMax=T_END)
        rc[0] = cli.main([p0], device="cpu")
        steps0 = len(_steps(d0))
        # the final snapshot, before the resume writes its own snp_001 (the
        # restart file is written before it and counts it not, as in JAX)
        last = str(tmp / "last")
        shutil.copy(os.path.join(d0, "snp_001"), last)
        # resume with a later TimeMax (the parameter file is re-read) and a
        # stop file: one step, then the restart file
        p1 = param_file(str(tmp / "p1.txt"), OutputDir=d0, InitCondFile=ic,
                        TimeMax=T_LATER)
        open(os.path.join(d0, "stop"), "w").close()
        rc[1] = cli.main([p1, "1"], device="cpu")
        # a parameter value is one token: the command is a script
        resubmit = tmp / "resubmit.sh"
        resubmit.write_text(f"#!/bin/sh\ntouch {d2}resubmitted\n")
        resubmit.chmod(0o755)
        p2 = param_file(str(tmp / "p2.txt"), OutputDir=d2,
                        InitCondFile=last, TimeMax=T_LATER,
                        TimeLimitCPU=1e-6, ResubmitOn=1,
                        ResubmitCommand=str(resubmit))
        rc[2] = cli.main([p2, "2"], device="cpu")
    finally:
        mp.undo()
    return rc, d0, d2, steps0, last


def test_flag0_runs_to_time_max(runs):
    rc, d0, _, steps0, last = runs
    assert rc[0] == 0
    assert steps0 == 2
    for name in ("parameters_out", "energy_out", "cpu_out", "timings_out",
                 "rst_out.npz", "snp_000", "snp_001"):
        assert os.path.exists(os.path.join(d0, name)), name
    last = read_snapshot(last)
    assert last.header.time == np.float32(T_END)
    assert last.n == N and np.isfinite(last.pos).all()
    with open(os.path.join(d0, "energy_out")) as f:
        rows = [line.split() for line in f]
    assert len(rows[0]) == 24
    events = [read_scatter_log(os.path.join(d0, n)) for n in os.listdir(d0)
              if n.startswith("sct_")]
    assert sum(len(e[0]) for e in events) > 0
    assert all(((e[1] >= 1) & (e[1] <= N) & (e[2] >= 1)
                & (e[2] <= N) & (e[1] != e[2])).all() for e in events)


def test_flag1_resumes_one_step_with_a_stop_file(runs):
    rc, d0, _, steps0, _ = runs
    assert rc[1] == 0
    steps = _steps(d0)
    assert len(steps) == steps0 + 1
    assert steps[-1].startswith(f"Begin Step {steps0 + 1},")
    _, rv = read_restart(os.path.join(d0, "rst_out.npz"), device="cpu")
    assert rv["step_count"] == steps0 + 1
    assert T_END < rv["time"] < T_LATER


def test_flag2_starts_from_a_snapshot_and_stops_at_the_cpu_limit(runs):
    rc, _, d2, _, _ = runs
    assert rc[2] == 0
    steps = _steps(d2)
    assert len(steps) == 1 and steps[0].startswith("Begin Step 1,")
    assert float(steps[0].split("Time: ")[1].split(",")[0]) > T_END
    snaps = sorted(n for n in os.listdir(d2) if n.startswith("snp_"))
    assert snaps == ["snp_000"]
    first = read_snapshot(os.path.join(d2, "snp_000"))
    assert first.header.time == np.float32(T_END)
    _, rv = read_restart(os.path.join(d2, "rst_out.npz"), device="cpu")
    assert rv["step_count"] == 1 and T_END < rv["time"] < T_LATER
    # the resubmit command runs in the background
    for _ in range(600):
        if os.path.exists(os.path.join(d2, "resubmitted")):
            break
        time.sleep(0.05)
    assert os.path.exists(os.path.join(d2, "resubmitted"))


def test_usage_and_no_card():
    assert cli.main([]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli.main(["unused.txt"])
