"""The port's run loop against the JAX package's, on the CPU: the resume.

tests/data/torch_run_golden.npz holds JAX's output files after its first
run (``a``, tests/test_torch_run.py) and after a second
``Simulation(restart_flag=1)`` resumed from that run's restart file in the
same directory and ran 3 more steps (``b``). The port resumes in a
directory holding JAX's files after ``a``, JAX's restart file included:
a resume rebuilds the tree and restarts the list cadence, and its prepare
takes one step that no log records (JAX's, ROADMAP.md C.11), so it is held
against JAX's resume and not against an uninterrupted run. Held as
tests/torch_run_checks.py states; besides, the resume appends to the logs
and goes on with the step, snapshot and ``sct_`` numbers.
"""

import pytest
import torch

from tests import torch_run_checks as rc
from tests.make_torch_golden import RUN_STEPS

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    return rc.load_golden()


@pytest.fixture(scope="module")
def port(tmp_path_factory, golden):
    return rc.port_run(str(tmp_path_factory.mktemp("resume")), golden, "b")


def test_same_output_files(port, golden):
    rc.check_files(port[2], golden, "b")


def test_info_log_matches_jax(port, golden):
    rc.check_info(port[2], golden, "b")


def test_energy_log_matches_jax(port, golden):
    """Two rows of the first run, then two of the resume: at the time its
    prepare's step reached and at the next."""
    rc.check_energy(port[2], golden, "b", rows=4)


def test_snapshots_match_jax(port, golden, tmp_path):
    assert rc.check_snapshots(port[2], golden, "b", port[1],
                              str(tmp_path)) == ["snp_000", "snp_001",
                                                 "snp_002"]


def test_scatter_log_matches_jax(port, golden, tmp_path):
    rc.check_scatter_log(port[2], golden, "b", port[1], str(tmp_path))


def test_cpu_and_timings_logs_one_entry_per_step(port, golden):
    rc.check_step_logs(port[2], golden, "b")


def test_restart_file_matches_jax(port, golden, tmp_path):
    rc.check_restart(golden, "b", port[1], str(tmp_path))


def test_resume_appends_and_continues(port, golden):
    """The resumed run appends to JAX's logs (their first lines are JAX's
    run ``a``), goes on from step 7 and writes its snapshots and events
    under the numbers JAX's ``a`` reached."""
    a = rc.golden_files(golden, "a")
    files = port[2]
    for name in ("energy_out", "info_out", "cpu_out", "timings_out",
                 "sct_001.0", "sct_002.0"):
        assert files[name].startswith(a[name]), name
    for name in ("energy_out", "info_out", "cpu_out", "timings_out"):
        assert len(files[name]) > len(a[name]), name
    tail = files["info_out"][len(a["info_out"]):].decode()
    assert tail.strip().startswith(f"Begin Step {RUN_STEPS + 1},")
    assert set(files) - set(a) == {"snp_002", "sct_003.0"}
