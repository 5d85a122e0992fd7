"""The TreePM split in the port (sidm_tpu_torch/ops/pm.py, the periodic
mode of ops/wq_force.py and the periodic direct sum of ops/direct.py)
against the JAX package's, on the CPU, on tests/test_pm.py's 2048-particle
clustered cloud.

JAX's outputs are frozen in tests/data/torch_periodic_golden.npz (``sr_``,
``pm_``, ``pm2_``, ``pd_``, ``tp0_``, ``tp1_``; tests/make_torch_golden.py
``periodic``). Tolerances, each against the largest magnitude of JAX's:
- the screened pair functions: as tests/test_pm.py's f64 check, within
  2e-6 of softened_inv_r3 (the port evaluates the Newtonian range as
  S(r)/r^3 and -erfc(a r)/r, JAX as differences that cancel near rcut);
- the deposit: 1e-6 (index_add_ against JAX's sorted segment sums: the
  same float32 terms in another order);
- pm_accel: 1e-5 (torch.fft's rfftn against JAX's matmul DFTs);
- the periodic direct sum on JAX's own Ewald tables: 1e-5;
- the walk's periodic mode: the same segments as JAX's, acc within 2e-4
  and pot within 1e-4 (erfc and exp by torch and by XLA; the screened
  potential's form, above);
- TreePM against the Ewald oracle: tests/test_pm.py's bars.
"""

import math

import numpy as np
import pytest
import torch

from sidm_tpu_torch.kernels import softened_inv_r3
from sidm_tpu_torch.ops import pm
from sidm_tpu_torch.ops.direct import direct_gravity
from sidm_tpu_torch.ops.ewald import PSI0, EwaldTable
from sidm_tpu_torch.ops.wq_force import wq_gravity
from tests.make_torch_golden import (PERIODIC_GOLDEN, PM2, PM_CLOUD, SR,
                                     pm_cloud)

torch.set_num_threads(2)
C = PM_CLOUD


@pytest.fixture(scope="module")
def golden():
    with np.load(PERIODIC_GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def cloud():
    return tuple(torch.tensor(a) for a in pm_cloud())


@pytest.fixture(scope="module")
def kern():
    return pm.build_pm_kernel(C["box"], n=C["mesh"], asmth=C["asmth"],
                              rcut_fac=C["rcut_fac"])


def close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= tol, err


def test_short_range_functions_match_jax(golden):
    r = torch.tensor(golden["sr_r"])
    h = torch.tensor(SR["h"], dtype=torch.float32)
    a = SR["alpha"]
    close(pm.short_range_screen(r, a), golden["sr_screen"], 1e-6)
    base = softened_inv_r3(r, h).numpy().astype(np.float64)
    f = pm.short_range_fac(r, h, a).numpy()
    assert np.all(np.abs(f - golden["sr_fac"]) <= 2e-6 * np.abs(base) + 1e-12)
    p = pm.short_range_pot(r, h, a).numpy()
    assert np.all(np.abs(p - golden["sr_pot"])
                  <= 2e-6 * np.abs(golden["sr_pot"]) + 1e-6 * a)


def test_short_range_fac_matches_f64_reference():
    """tests/test_pm.py's check: the series-stabilised factor against a
    float64 math.erf evaluation across the switch (a r in [0, 2])."""
    alpha, h = 0.32, 2.8 * 0.15
    r_np = np.linspace(1e-4, 2.0, 400) / alpha
    f = pm.short_range_fac(torch.tensor(r_np, dtype=torch.float32),
                           torch.tensor(h, dtype=torch.float32), alpha)
    base = softened_inv_r3(torch.tensor(r_np, dtype=torch.float32),
                           torch.tensor(h, dtype=torch.float32)).numpy()
    for i in range(0, 400, 7):
        x = alpha * r_np[i]
        g = (math.erf(x) - 2.0 * x * math.exp(-x * x) / math.sqrt(math.pi)
             ) / r_np[i] ** 3
        assert abs(float(f[i]) - (base[i] - g)) <= 2e-6 * abs(base[i]) \
            + 1e-12


def test_cic_deposit_matches_jax(golden, cloud):
    pos, mass, _ = cloud
    rho = pm.cic_deposit(pos, mass, C["box"], C["mesh"])
    close(rho, golden["pm_rho"], 1e-6)
    assert float(rho.double().sum()) == pytest.approx(float(mass.sum()),
                                                      rel=1e-5)


def test_pm_accel_and_pot_self_match_jax(golden, cloud, kern):
    pos, mass, _ = cloud
    assert kern.alpha == pytest.approx(float(golden["pm_alpha"]), rel=1e-12)
    assert kern.rcut == pytest.approx(float(golden["pm_rcut"]), rel=1e-12)
    assert kern.pot_self == pytest.approx(float(golden["pm_pot_self"]),
                                          rel=1e-5)
    a, p = pm.pm_accel(kern, pos, mass, with_potential=True)
    close(a, golden["pm_acc"], 1e-5)
    close(p, golden["pm_pot"], 1e-5)
    k2 = pm.build_pm_kernel(C["box"], n=PM2["mesh"], asmth=PM2["asmth"],
                            rcut_fac=PM2["rcut_fac"],
                            interlace=PM2["interlace"])
    assert k2.pot_self == pytest.approx(float(golden["pm2_pot_self"]),
                                        rel=1e-5)
    a, p = pm.pm_accel(k2, pos, mass, with_potential=True)
    close(a, golden["pm2_acc"], 1e-5)
    close(p, golden["pm2_pot"], 1e-5)


def jax_table(golden):
    box = C["box"]
    return EwaldTable(torch.tensor(golden["ew_fcorr"] / box ** 2),
                      torch.tensor(golden["ew_potcorr"] / box), box, 64)


def test_periodic_direct_sum_matches_jax(golden, cloud):
    pos, mass, eps = cloud
    tg = torch.arange(0, C["n"], 8)
    a, p = direct_gravity(pos, mass, eps, targets=tg, box=C["box"],
                          ewald=jax_table(golden))
    close(a, golden["pd_acc"][::8], 1e-5)
    close(p, golden["pd_pot"][::8], 1e-5)


@pytest.fixture(scope="module")
def walks(golden, cloud, kern):
    pos, mass, eps = cloud
    pbc = (C["box"], kern.alpha, kern.rcut)
    out = {}
    for opening in (0, 1):
        old = torch.tensor(golden[f"tp{opening}_old"])
        out[opening] = wq_gravity(pos, mass, eps, old, theta=0.5,
                                  opening=opening, pbc=pbc,
                                  return_info=True)
    return out


@pytest.mark.parametrize("opening", [0, 1])
def test_periodic_walk_matches_jax(golden, walks, opening):
    a, p, info = walks[opening]
    for k in ("n_segs", "ovf_open", "ovf_big"):
        assert int(info[k]) == int(golden[f"tp{opening}_{k}"]), k
    close(a, golden[f"tp{opening}_acc"], 2e-4)
    close(p, golden[f"tp{opening}_pot"], 1e-4)


def test_treepm_matches_ewald_oracle(golden, cloud, kern, walks):
    """tests/test_pm.py's bars, against JAX's Ewald direct sum, with the
    potential assembled as Simulation assembles it (psi(0), the mesh's
    self term, the short range's mean)."""
    pos, mass, _ = cloud
    acc_s, pot_s, _ = walks[0]
    acc_l, pot_l = pm.pm_accel(kern, pos, mass, with_potential=True)
    box = C["box"]
    acc = (acc_s + acc_l).double().numpy()
    pot = (pot_s + pot_l + mass * (PSI0 / box - kern.pot_self)
           + math.pi * float(mass.sum()) / (kern.alpha ** 2 * box ** 3)
           ).double().numpy()
    acc_ref, pot_ref = golden["pd_acc"], golden["pd_pot"]
    anorm = np.linalg.norm(acc_ref, axis=1)
    rel = np.linalg.norm(acc - acc_ref, axis=1) / np.maximum(
        anorm, np.percentile(anorm, 50))
    assert np.percentile(rel, 99) < 2.5e-3 and rel.max() < 6e-3
    pscale = np.percentile(np.abs(pot_ref), 50)
    perr = np.abs(pot - pot_ref) / np.maximum(np.abs(pot_ref), pscale)
    assert np.percentile(perr, 99) < 8e-3
    m = mass.double().numpy()
    e_ref = 0.5 * np.sum(m * pot_ref)
    assert abs(0.5 * np.sum(m * pot) - e_ref) / abs(e_ref) < 5e-3
