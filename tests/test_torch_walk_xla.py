"""The port's work-queue walk vs the JAX XLA path with the relative
opening criterion (opening 1; JAX's outputs frozen in
tests/data/torch_walk_golden.npz), and the direct-sum oracle on a
Hernquist halo; see test_torch_walk.py for the tolerances."""

import torch

from tests.test_torch_walk import (check_walk_matches_jax,
                                   check_walk_vs_direct_oracle)

torch.set_num_threads(2)


def test_walk_matches_jax_relative():
    check_walk_matches_jax(1)


def test_walk_vs_direct_oracle_hernquist():
    check_walk_vs_direct_oracle("hernquist")
