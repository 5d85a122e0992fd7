"""The port's run loop against the JAX package's, on the CPU: the first
run.

The JAX side is frozen in tests/data/torch_run_golden.npz (``python -m
tests.make_torch_golden run``): ``Simulation(mode="phased")`` on
``RUN_CONFIG`` (flagship-dsmc at N = 2048 with ``CrossSection`` raised
100x as in tests/test_torch_sidm_slice.py, ``ScatterLog 1``, two
statistics and two snapshots in the window) from a Gadget IC: ``load_ic``,
prepare, ``run(max_steps=6)`` (``a``); then a resume (``b``,
tests/test_torch_run_resume.py). The port repeats ``a`` from its own IC
file; its outputs are held to JAX's as tests/torch_run_checks.py states.
The CLI runs end to end in tests/test_torch_cli.py.
"""

import numpy as np
import pytest
import torch

from tests import torch_run_checks as rc
from tests.make_torch_golden import jax_run

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    return rc.load_golden()


@pytest.fixture(scope="module")
def port(tmp_path_factory, golden):
    return rc.port_run(str(tmp_path_factory.mktemp("run")), golden, "a")


def test_ic_bytes_equal_jax(port, golden):
    assert port[0] == golden["ic"].tobytes()


def test_same_output_files(port, golden):
    rc.check_files(port[2], golden, "a")


def test_info_log_matches_jax(port, golden):
    rc.check_info(port[2], golden, "a")


def test_energy_log_matches_jax(port, golden):
    """Two statistics in the window (t = 0 and the fourth step's start)."""
    rc.check_energy(port[2], golden, "a", rows=2)


def test_snapshots_match_jax(port, golden, tmp_path):
    assert rc.check_snapshots(port[2], golden, "a", port[1],
                              str(tmp_path)) == ["snp_000", "snp_001"]


def test_scatter_log_matches_jax(port, golden, tmp_path):
    rc.check_scatter_log(port[2], golden, "a", port[1], str(tmp_path))


def test_cpu_and_timings_logs_one_entry_per_step(port, golden):
    rc.check_step_logs(port[2], golden, "a")


def test_restart_file_matches_jax(port, golden, tmp_path):
    rc.check_restart(golden, "a", port[1], str(tmp_path))


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """The committed golden file is what the JAX run loop gives now (the
    CPU and timings logs and the restart file hold wall times: left
    out)."""
    live = jax_run()
    assert sorted(live) == sorted(golden)
    for k, v in live.items():
        if k.endswith(("cpu_out", "timings_out", "rst_out.npz")):
            continue
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
