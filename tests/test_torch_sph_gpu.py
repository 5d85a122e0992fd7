"""H5 and H6 (``csrc/hash_sph.cu``) against their plain versions on the
card (``gpu`` marker: skipped without one; on the card ``python -m pytest
tests/ -q -m gpu -k torch_sph``), at ``chip_smoke.py`` phase 17's bars:

* H1 (``knn_radius``) on the density pass's queries and warm radii: h,
  counts, overflow, need, clip and rows read bit-equal;
* H5 (``sph_density_sums``): counts, need, clip and rows read equal, the
  float64 rho, divv and rot p99.9 relative error <= 1e-6 (the same float32
  terms summed in another order);
* H6 (``hydro_pairs``): pairs, need, clip and rows read equal, acc (per
  particle, relative to |a|) and dt_egy p99.9 <= 1e-5 (atomic float64
  adds in another order), and with every gas particle active the momentum
  |sum m a| <= 1e-5 sum m |a|.

Inputs: gas-halo's halo (``gas_ics``, N = 16384, its pass grown to the
demand from no smoothing length and again from its lengths by
``grown_pass``, then checked from its lengths), free space;
tests/test_torch_sph.py's periodic comoving box (``x``: 60 % active, dark
matter among the gas) at JAX's cap of 128 and at a cap past every bucket;
each at a cap of 8 too (rows dropped: the counts still equal). Each call
counts one launch. This file does not import JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sidm_tpu_torch.flagship import GAS, gas_ics
from sidm_tpu_torch.ops.neighbors import knn_radius
from sidm_tpu_torch.ops import sph as ts
from sidm_tpu_torch.state import make_particles
from tests.test_torch_sph import sph_setup


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def q999(x):
    return float(torch.quantile(x.double().flatten(), 0.999))


def halo(dev):
    """gas-halo's halo at N = 16384 after two grown passes: (p, t,
    active, params, box, cap, levels)."""
    n = 16384
    pos, vel, mass, ptype = gas_ics(n, 12345)
    p = make_particles(pos, vel, mass, ptype, egy_spec=np.where(
        ptype == 0, 620.0, 0.0), pad_to_multiple=256, device=dev)
    prm = ts.SphParams(des_num_ngb=30, max_num_ngb_dev=2,
                       art_bulk_visc=GAS["ArtBulkViscConst"],
                       min_egy_spec=0.0, min_gas_hsml=0.0, comoving=False,
                       hubble=0.1, omega0=0.0, omega_lambda=0.0)
    t = torch.tensor(0.01, device=dev)
    p = dataclasses.replace(p, current_time=torch.full_like(
        p.current_time, 0.005))
    r = ts.grown_pass(p, p.pos, p.vel, t, p.valid, prm, cap=prm.cap,
                      n_levels=10)
    r = ts.grown_pass(r.p, p.pos, p.vel, t, p.valid, prm, cap=r.cap,
                      n_levels=r.levels)
    assert r.stats["ngb_ovf"] == 0 and r.stats["lvl_clip"] == 0, r.stats
    return r.p, t, p.valid, prm, 0.0, r.cap, r.levels


def check(p, t, active, prm, box, cap, levels):
    q, dinfo = ts.sph_density_plain(p, p.pos, p.vel, t, active, prm,
                                    box=box, cap=cap, n_levels=levels)
    sel = dinfo["sel"]
    kargs = (dinfo["table"], p.pos[sel].contiguous(),
             p.ptype[sel].contiguous(), dinfo["warm"], prm.des_num_ngb)
    n0 = knn_radius.launches
    k = knn_radius(*kargs, cap=cap, n_iter=3)
    assert knn_radius.launches == n0 + 1
    for f in ("h", "cnt", "ovf", "need", "clip", "scanned"):
        assert torch.equal(getattr(k, f), getattr(dinfo["knn"], f).to(
            getattr(k, f).dtype)), f
    args = (dinfo["table"], p.pos[sel].contiguous(), p.vel[sel].contiguous(),
            p.ptype[sel].contiguous(), q.hsml[sel].contiguous())
    n0 = ts.sph_density_sums.launches
    k = ts.sph_density_sums(*args, cap=cap)
    assert ts.sph_density_sums.launches == n0 + 1
    s = ts.sph_density_sums_plain(*args, cap=cap)
    for f in ("cnt", "need", "clip", "scanned"):
        assert torch.equal(getattr(k, f), getattr(s, f).to(
            getattr(k, f).dtype)), f
    for f in ("rho", "divv", "rot"):
        a, b = getattr(k, f), getattr(s, f)
        err = q999(torch.abs(a - b) / torch.clamp(torch.abs(b), min=1e-300))
        assert err <= 1e-6, (f, err)
    _, _, hinfo = ts.hydro_force_plain(q, p.pos, p.vel, t, active, prm,
                                       dinfo["table"], box=box, cap=cap)
    hsel = hinfo["sel"]
    hargs = (hinfo["table"], p.pos[hsel].contiguous(),
             p.vel[hsel].contiguous(), p.ptype[hsel].contiguous(),
             q.hsml[hsel].contiguous(), hsel.to(torch.int32), hinfo["qv"],
             p.pos.shape[0], hinfo["factors"])
    n0 = ts.hydro_pairs.launches
    k = ts.hydro_pairs(*hargs, cap=cap)
    assert ts.hydro_pairs.launches == n0 + 1
    s = hinfo["out"]
    for f in ("pairs", "need", "clip", "scanned"):
        assert torch.equal(getattr(k, f), getattr(s, f).to(
            getattr(k, f).dtype)), f
    a, b = k.acc[hsel], s.acc[hsel]
    err = torch.linalg.norm(a - b, dim=1) / torch.clamp(
        torch.linalg.norm(b, dim=1), min=1e-300)
    assert q999(err) <= 1e-5, q999(err)
    e = torch.abs(k.dt_egy[hsel] - s.dt_egy[hsel]) / torch.clamp(
        torch.abs(s.dt_egy[hsel]), min=1e-300)
    assert q999(e) <= 1e-5, q999(e)
    if bool(torch.all(active[hsel])):
        ma = p.mass[hsel].double()[:, None] * k.acc[hsel]
        mom = torch.linalg.norm(ma.sum(0)) / torch.sum(
            torch.linalg.norm(ma, dim=1))
        assert float(mom) <= 1e-5, float(mom)


@pytest.mark.gpu
@pytest.mark.parametrize("small_cap", [False, True])
def test_sph_kernels_match_plain_free_space(cuda, small_cap):
    p, t, active, prm, box, cap, levels = halo(cuda)
    check(p, t, active, prm, box, 8 if small_cap else cap, levels)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [8, 128, 4096])
def test_sph_kernels_match_plain_periodic_comoving(cuda, cap):
    p, t, active, prm, box = sph_setup("x", device=cuda)
    check(p, t, active, prm, box, cap, 10)
