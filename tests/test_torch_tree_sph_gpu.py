"""T1, T2 and T3 (the tree SPH engine's kernels: the hmax mode of
``csrc/range_walk.cu`` and ``csrc/tree_sph.cu``) against their plain
versions on the card (``gpu`` marker: skipped without one; on the card
``python -m pytest tests/ -q -m gpu -k tree_sph``):

* T1 (``range_segments(use_hmax=True)``) on the hydro walk of the pass's
  groups: keys with their IMAX tails, counts, ovf, need, telemetry and
  drops bit-equal to ``range_walk_plain``, one ``range_hmax_launches`` a
  walk; the density walk (plain pad) too, one ``range_launches``;
* T2 (``tree_density_sums``) on every pass of ``sph_density_fused``
  (the controller's count passes and the final one): counts equal, the
  float64 rho, divv and rot p99.9 of |a - b| / max(|b|, median |b|) <=
  1e-12 (the same float32 terms summed in another order);
* T3 (``tree_hydro_sums``): pairs equal, acc and dt_egy at the same bar,
  and with every gas particle active the momentum |sum m a| <= 1e-5
  sum m |a|;
* the whole drivers on the kernels against the drivers on the plain
  versions: hsml and ngb_sph equal, the other fields within 1e-6 of
  their largest.

Inputs: gas-halo's halo (``gas_ics``, N = 16384, from no smoothing
length), free space, and tests/test_torch_sph.py's periodic comoving box
(``x``: 60 % active, dark matter among the gas); the walks also with small
caps (each dropping, then grown). This file does not import JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sidm_tpu_torch.flagship import GAS, gas_ics
from sidm_tpu_torch.ops import fused_sph as fs
from sidm_tpu_torch.ops.far_kernel import far_level
from sidm_tpu_torch.ops.fused_force import FusedConfig
from sidm_tpu_torch.ops.fused_range import range_segments, range_walk_plain
from sidm_tpu_torch.ops.sph import SphParams
from sidm_tpu_torch.ops.tree import build_octree
from sidm_tpu_torch.state import make_particles
from tests.test_torch_sph import sph_setup


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def q999(x):
    return float(torch.quantile(x.double().flatten(), 0.999))


def scaled_p999(a, b):
    """p99.9 of |a - b| / max(|b|, median |b|)."""
    a, b = a.double().flatten(), b.double().flatten()
    if not b.numel():
        return 0.0
    ref = torch.clamp(torch.abs(b), min=float(torch.median(torch.abs(b))))
    return q999(torch.abs(a - b) / torch.clamp(ref, min=1e-300))


def halo(dev):
    """gas-halo's halo at N = 16384: (p, t, active, params, box, tree)."""
    n = 16384
    pos, vel, mass, ptype = gas_ics(n, 12345)
    p = make_particles(pos, vel, mass, ptype, egy_spec=np.where(
        ptype == 0, 620.0, 0.0), pad_to_multiple=256, device=dev)
    prm = SphParams(des_num_ngb=30, max_num_ngb_dev=2,
                    art_bulk_visc=GAS["ArtBulkViscConst"], min_egy_spec=0.0,
                    min_gas_hsml=0.0, comoving=False, hubble=0.1, omega0=0.0,
                    omega_lambda=0.0)
    p = dataclasses.replace(p, current_time=torch.full_like(
        p.current_time, 0.005))
    t = torch.tensor(0.01, device=dev)
    return p, t, p.valid, prm, 0.0


def tree_of(p, box):
    eps = torch.full_like(p.mass, 0.3)
    return build_octree(p.pos, torch.where(p.valid, p.mass,
                                           torch.zeros_like(p.mass)), eps,
                        p.valid, box=box, depth=10)


def check_walk(kw, use_hmax, cfg=None):
    """range_segments on the card against range_walk_plain on kw."""
    attr = "range_hmax_launches" if use_hmax else "range_launches"
    n0 = getattr(far_level, attr)
    dk, dp = {}, {}
    k = range_segments(**kw, cfg=cfg, use_hmax=use_hmax, drops=dk)
    assert getattr(far_level, attr) == n0 + 1
    p = range_walk_plain(**kw, cfg=cfg, use_hmax=use_hmax, drops=dp)
    for a, b, what in zip(k, p, ("keys", "nn", "ovf", "need", "stat")):
        assert torch.equal(a.long(), b.long()), what
    for key in ("open", "big_over", "big_drop"):
        assert int(dk[key]) == int(dp[key]), key
    return int(k[2]), dk


def run(setup, dev):
    p, t, active, prm, box = setup(dev)
    tree = tree_of(p, box)
    dens, hyd = [], []
    q, dinfo = fs.sph_density_fused(p, p.pos, p.vel, tree, t, active, prm,
                                    box=box, on_pass=dens.append)
    acc, de, hinfo = fs.hydro_force_fused(q, p.pos, p.vel, tree, t, active,
                                          prm, box=box, on_pass=hyd.append)
    return p, t, active, prm, box, tree, q, acc, de, dens, hyd


@pytest.fixture(scope="module", params=["halo", "box"])
def case(request, cuda):
    setup = halo if request.param == "halo" else (
        lambda dev: sph_setup("x", device=dev))
    return run(setup, cuda)


@pytest.mark.gpu
def test_t1_walks_match_plain(case):
    p, t, active, prm, box, tree, q, *_ = case
    hs = torch.where(p.is_gas, q.hsml, torch.zeros_like(q.hsml))[tree.perm]
    pidx, gvalid = fs._gas_windows(tree, hs)
    ps = p.pos[tree.perm]
    gt = torch.where(gvalid[..., None], ps[pidx], 0.0).contiguous()
    gh = torch.where(gvalid, hs[pidx], 0.0).contiguous()
    glo, ghi, pad = fs._group_bbox(gt, gvalid & (gh > 0), gh, tree, box)
    for use_hmax in (False, True):
        rlev = fs.range_levels(tree, hs if use_hmax else None)
        kw = dict(tree=tree, rlev=rlev, glo=glo, ghi=ghi, pad=pad,
                  seg_cap=8192, box=box)
        ovf, _ = check_walk(kw, use_hmax)
        assert ovf == 0
        # small caps: every kind of drop
        ovf, d = check_walk(dict(kw, seg_cap=64), use_hmax,
                            FusedConfig(w_max=64, open_cap=8, big_cap=1,
                                        big_chunks=1))
        assert ovf > 0


@pytest.mark.gpu
def test_t2_matches_plain(case):
    dens = case[9]
    assert len(dens) == 5
    for kw in dens:
        n0 = (fs.tree_density_sums.count_launches if kw["count_only"]
              else fs.tree_density_sums.launches)
        k = fs.tree_density_sums(**kw)
        n1 = (fs.tree_density_sums.count_launches if kw["count_only"]
              else fs.tree_density_sums.launches)
        assert n1 == n0 + 1
        s = fs.tree_density_sums_plain(**kw)
        assert torch.equal(k.cnt, s.cnt)
        live = fs._live(kw["gidx"], kw["gh"])
        if kw["count_only"]:
            continue
        for f in ("rho", "divv", "rot"):
            err = scaled_p999(getattr(k, f)[live], getattr(s, f)[live])
            assert err <= 1e-12, (f, err)


@pytest.mark.gpu
def test_t3_matches_plain(case):
    p, t, active, prm, box, tree, q, acc, de, dens, hyd = case
    (kw,) = hyd
    n0 = fs.tree_hydro_sums.launches
    k = fs.tree_hydro_sums(**kw)
    assert fs.tree_hydro_sums.launches == n0 + 1
    s = fs.tree_hydro_sums_plain(**kw)
    assert torch.equal(k.pairs, s.pairs)
    live = fs._live(kw["gidx"], kw["gq"][..., 0])
    for f in ("acc", "dt_egy"):
        err = scaled_p999(getattr(k, f)[live], getattr(s, f)[live])
        assert err <= 1e-12, (f, err)
    gas = p.is_gas & active
    if bool(torch.all(active[p.is_gas])):
        ma = p.mass[gas].double()[:, None] * acc[gas].double()
        mom = torch.linalg.norm(ma.sum(0)) / torch.sum(
            torch.linalg.norm(ma, dim=1))
        assert float(mom) <= 1e-5, float(mom)


@pytest.mark.gpu
def test_drivers_match_plain(case):
    p, t, active, prm, box, tree, q, acc, de, *_ = case
    qp, _ = fs.sph_density_fused(p, p.pos, p.vel, tree, t, active, prm,
                                 box=box, plain=True)
    ap, dp, _ = fs.hydro_force_fused(qp, p.pos, p.vel, tree, t, active, prm,
                                     box=box, plain=True)
    assert torch.equal(q.hsml, qp.hsml)
    assert torch.equal(q.ngb_sph, qp.ngb_sph)
    for a, b in ((q.density, qp.density), (q.div_vel, qp.div_vel),
                 (q.curl_vel, qp.curl_vel), (q.dt_hsml, qp.dt_hsml),
                 (acc, ap), (de, dp)):
        err = float(torch.max(torch.abs(a - b))
                    / torch.clamp(torch.max(torch.abs(b)), min=1e-30))
        assert err <= 1e-6, err
