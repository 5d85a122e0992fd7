"""DSMC in periodic and comoving runs on the hash engine of the single-program
step (``mode="synchronized"``: H1 and H2 on the box's hash grid) against the
JAX Simulation's states, step by step, on the CPU: in the box (``b``),
comoving (``c``) and both (``x``); the checks and their tolerances are
tests/torch_cosmo_dsmc_checks.py's.
"""

import pytest
import torch

from tests.torch_cosmo_dsmc_checks import (VARIANTS, check_against_jax,
                                           load_golden, run_port)

torch.set_num_threads(2)

ENGINE = "h"


@pytest.fixture(scope="module")
def golden():
    return load_golden(ENGINE)


@pytest.mark.parametrize("variant", VARIANTS)
def test_dsmc_matches_jax(tmp_path, golden, variant):
    sim, states, sct = run_port(tmp_path, variant, ENGINE)
    check_against_jax(sim, states, sct, golden, f"d{variant}{ENGINE}",
                      ENGINE)
