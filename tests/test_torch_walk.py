"""The port's work-queue walk (``sidm_tpu_torch.ops.wq_force``) vs the JAX
engine, and vs the port's direct-sum oracle.

n = 2048, depth 8. Opening 0 is held against JAX ``wq_gravity`` with the
Pallas kernels (``FusedConfig(wq_pallas=True)``, interpret mode on the
CPU); opening 1 against the JAX XLA path is in test_torch_walk_xla.py. The
JAX outputs are frozen in tests/data/torch_walk_golden.npz (``python -m
tests.make_torch_golden walk``: the interpreted Pallas walk alone takes
over a minute of the CPU); the JAX runs used small super-blocks
(``wq_block``/``wq_near_block``), a TPU scheduling knob that leaves the
walk unchanged. Held: equal ``n_segs`` and item counts, zero overflow,
acceleration p99.9 relative error < 2e-5, potential rtol 2e-5; against
the direct sum p99 <= 1e-3 (the repo's oracle bar)."""

import numpy as np
import torch

from sidm_tpu_torch.io import ics
from sidm_tpu_torch.ops.direct import direct_gravity
from sidm_tpu_torch.ops.wq_force import wq_gravity
from tests.make_torch_golden import WALK, WALK_GOLDEN, walk_inputs

torch.set_num_threads(2)

N, DEPTH = WALK["n"], WALK["depth"]


def _err(a, b):
    return (np.linalg.norm(a - b, axis=1)
            / np.maximum(np.linalg.norm(b, axis=1), 1e-12))


def _setup(model="plummer", seed=5):
    pos, _, m = getattr(ics, model)(N, seed=seed)
    return (pos.astype(np.float32), m.astype(np.float32),
            np.full(N, 0.05, np.float32))


def _port(pos, m, eps, old, opening):
    acc, pot, info = wq_gravity(
        torch.tensor(pos), torch.tensor(m), torch.tensor(eps),
        torch.tensor(old), theta=0.5, opening=opening, depth=DEPTH,
        return_info=True)
    return acc.numpy(), pot.numpy(), {k: v.tolist() for k, v in info.items()}


def check_walk_matches_jax(opening):
    """The port's walk on ``walk_inputs(opening)`` against JAX's frozen
    outputs (``w{opening}_``)."""
    pos, m, eps, old = walk_inputs(opening)
    with np.load(WALK_GOLDEN) as z:
        acc_j, pot_j = z[f"w{opening}_acc"], z[f"w{opening}_pot"]
        info_j = {k: int(z[f"w{opening}_{k}"])
                  for k in ("ovf_items", "n_segs", "max_walk_items",
                            "max_near_items")}
    acc_t, pot_t, info_t = _port(pos, m, eps, old, opening)
    assert info_j["ovf_items"] == 0
    for k in ("ovf_open", "ovf_big", "ovf_items"):
        assert info_t[k] == 0, k
    for k in ("n_segs", "max_walk_items", "max_near_items"):
        assert info_t[k] == info_j[k], k
    assert np.quantile(_err(acc_t, acc_j), 0.999) < 2e-5
    np.testing.assert_allclose(pot_t, pot_j, rtol=2e-5, atol=1e-7)


def test_walk_matches_jax_pallas():
    check_walk_matches_jax(0)


def check_walk_vs_direct_oracle(model):
    pos, m, eps = _setup(model, seed=11)
    acc_t, pot_t, info = _port(pos, m, eps, np.zeros(N, np.float32), 0)
    acc_d, pot_d = direct_gravity(torch.tensor(pos), torch.tensor(m),
                                  torch.tensor(eps))
    assert info["ovf_open"] == 0 and info["ovf_big"] == 0
    assert np.quantile(_err(acc_t, acc_d.numpy()), 0.99) <= 1e-3
    perr = np.abs(pot_t - pot_d.numpy()) / np.abs(pot_d.numpy())
    assert np.quantile(perr, 0.99) < 2e-3


def test_walk_vs_direct_oracle():
    check_walk_vs_direct_oracle("plummer")


def test_walk_invalid_particles_ignored():
    pos, m, eps = _setup(seed=13)
    m[::7] = 0.0
    acc, pot, _ = _port(pos, m, eps, np.zeros(N, np.float32), 0)
    assert np.all(acc[::7] == 0.0) and np.all(pot[::7] == 0.0)
    assert np.all(np.isfinite(acc))
