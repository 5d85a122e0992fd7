"""The port's command line, ``python -m sidm_tpu_torch <parameterfile>``
(``cli.main``), on the single-program step: a 4096-particle Gadget IC of
the NFW halo with tests/test_torch_run.py's configuration (flagship-dsmc's
SIDM settings, ``mode="synchronized"``) and a ``TimeMax`` of two steps, on
the CPU (``device="cpu"``), with ``Simulation.PHASE_THRESHOLD`` untouched
(262144): the step is the single-program one (the hash engine, the wq
walk), prepare's included; the run ends with its info lines and
snapshots.
"""

import os

import pytest
import torch

from sidm_tpu_torch import cli
from sidm_tpu_torch.config import SimConfig, write_parameters_out
from sidm_tpu_torch.io.gadget import GadgetHeader, Snapshot, write_snapshot
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import RUN_CONFIG, run_ic

torch.set_num_threads(2)


def test_cli_runs_small_ic_on_single_program_step(tmp_path):
    """``python -m sidm_tpu_torch param`` on a 4096-particle Gadget IC,
    ``Simulation.PHASE_THRESHOLD`` untouched: the single-program step."""
    assert Simulation.PHASE_THRESHOLD == 262144
    ic = str(tmp_path / "ic")
    write_snapshot(ic, run_ic(Snapshot, GadgetHeader, 4096))
    out = str(tmp_path / "out") + "/"
    os.makedirs(out)
    cfg = SimConfig(**{**RUN_CONFIG, "OutputDir": out, "InitCondFile": ic,
                       "TimeMax": 2.0 ** -12, "ScatterLog": 0})
    param = write_parameters_out(cfg, str(tmp_path))
    seen = []
    orig = Simulation._step_single

    def spy(self, first):
        seen.append(first)
        return orig(self, first)

    mp = pytest.MonkeyPatch()
    mp.setattr(Simulation, "_step_single", spy)
    try:
        assert cli.main([param], device="cpu") == 0
    finally:
        mp.undo()
    with open(os.path.join(out, "info_out")) as f:
        steps = [line for line in f if line.startswith("Begin Step")]
    assert seen[0] and len(seen) == len(steps) + 1 >= 2
    assert os.path.exists(os.path.join(out, "snp_000"))
