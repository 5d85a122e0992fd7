"""The port's Ewald tables (sidm_tpu_torch/ops/ewald.py) against the JAX
package's, on the CPU.

The JAX tables and lookups are frozen in tests/data/torch_periodic_golden.npz
(``ew_``; tests/make_torch_golden.py ``periodic``). Tolerances:
- the tables: the port builds them in float64, JAX in float32, whose force
  table near the origin loses ~1e-4 of its largest entry to the
  cancellation of 1/r^2 against the lattice sum: fcorr within 2e-4 of its
  largest entry, potcorr within 1e-5;
- the lookups, on JAX's own tables: the same float32 arithmetic, within
  1e-6 of the largest correction;
- tests/test_ewald.py's properties, with the port's table, at that test's
  bars.
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.ops.direct import direct_gravity
from sidm_tpu_torch.ops.ewald import PSI0, EwaldTable, build_ewald_table
from tests.make_torch_golden import PERIODIC_GOLDEN, PM_CLOUD

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    with np.load(PERIODIC_GOLDEN) as z:
        return {k: z[k] for k in z.files if k.startswith("ew_")}


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    d = tmp_path_factory.mktemp("ewald")
    return build_ewald_table(1.0, en=64, cache_dir=str(d))


def test_tables_match_jax(table, golden):
    f, p = table.fcorr.numpy(), table.potcorr.numpy()
    fj, pj = golden["ew_fcorr"], golden["ew_potcorr"]
    assert f.shape == fj.shape == (3, 33, 33, 33)
    assert np.abs(f - fj).max() <= 2e-4 * np.abs(fj).max()
    assert np.abs(p - pj).max() <= 1e-5 * np.abs(pj).max()
    assert p[0, 0, 0] == np.float32(PSI0)


def test_lookups_match_jax_on_its_tables(golden):
    box = PM_CLOUD["box"]
    tab = EwaldTable(torch.tensor(golden["ew_fcorr"] / box ** 2),
                     torch.tensor(golden["ew_potcorr"] / box), box, 64)
    d = torch.tensor(golden["ew_d"])
    fc, pc = tab.force_correction(d).numpy(), tab.pot_correction(d).numpy()
    assert np.abs(fc - golden["ew_fc"]).max() <= \
        1e-6 * np.abs(golden["ew_fc"]).max()
    assert np.abs(pc - golden["ew_pc"]).max() <= \
        1e-6 * np.abs(golden["ew_pc"]).max()
    assert np.all(fc[:3] == 0.0)            # d = 0: no force correction


def test_cache_is_the_ports_own(tmp_path):
    """A JAX cache file in the same directory is not read; the port writes
    its own and reads it back."""
    np.savez_compressed(tmp_path / "ewald_table_16.npz",
                        fcorr=np.zeros((3, 9, 9, 9)),
                        potcorr=np.zeros((9, 9, 9)))
    a = build_ewald_table(2.0, en=16, cache_dir=str(tmp_path))
    assert (tmp_path / "ewald_table_torch_16.npz").exists()
    assert float(a.potcorr[0, 0, 0]) == pytest.approx(PSI0 / 2.0, rel=1e-6)
    b = build_ewald_table(2.0, en=16, cache_dir=str(tmp_path))
    assert torch.equal(a.fcorr, b.fcorr) and torch.equal(a.potcorr,
                                                         b.potcorr)


# tests/test_ewald.py's properties, on the port's table

def _fc(table, d):
    return table.force_correction(torch.tensor(d, dtype=torch.float32)
                                  [None, :])[0].numpy()


def test_half_box_force_cancels(table):
    for axis in range(3):
        d = np.zeros(3, np.float32)
        d[axis] = 0.5
        direct = d / np.linalg.norm(d) ** 3
        total = direct + _fc(table, d)
        assert np.abs(total).max() < 0.05 * np.abs(direct).max(), axis


def test_half_box_diagonal_cancels(table):
    d = np.array([0.5, 0.5, 0.5], np.float32)
    direct = d / np.sqrt(0.75) ** 3
    assert np.abs(direct + _fc(table, d)).max() < 0.05 * np.abs(direct).max()


def test_small_separation_correction_vanishes(table):
    d = np.array([0.01, 0.005, -0.02], np.float32)
    direct = d / np.linalg.norm(d) ** 3
    assert np.abs(_fc(table, d)).max() < 1e-2 * np.abs(direct).max()


def test_correction_antisymmetric(table):
    d = np.array([0.3, -0.1, 0.2], np.float32)
    np.testing.assert_allclose(_fc(table, d), -_fc(table, -d), atol=1e-7)


def test_pot_self_term(table):
    psi0 = float(table.pot_correction(torch.zeros(1, 3))[0])
    assert psi0 == pytest.approx(2.8372975, rel=1e-5)


def test_lattice_equilibrium(table):
    """4^3 cubic lattice in the unit box: zero force, equal potentials."""
    g = (np.arange(4) + 0.5) / 4.0
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    pos = torch.tensor(np.stack([x, y, z], -1).reshape(-1, 3),
                       dtype=torch.float32)
    n = len(pos)
    acc, pot = direct_gravity(pos, torch.full((n,), 1.0 / n),
                              torch.full((n,), 0.01), box=1.0, ewald=table,
                              target_block=64, source_chunk=64)
    fscale = 1.0 / 0.25 ** 2 / n
    assert float(acc.abs().max()) < 0.02 * fscale
    pot = pot.numpy()
    assert pot.std() < 1e-4 * np.abs(pot.mean())


def test_momentum_conserved_with_ewald(table):
    rng = np.random.default_rng(3)
    n = 128
    pos = torch.tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32)
    mass = torch.tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float32)
    acc, _ = direct_gravity(pos, mass, torch.full((n,), 0.02), box=1.0,
                            ewald=table, target_block=64, source_chunk=64)
    net = torch.sum(mass[:, None] * acc, 0).abs().max()
    scale = torch.mean(torch.abs(mass[:, None] * acc)) * n
    assert float(net / scale) < 1e-4
