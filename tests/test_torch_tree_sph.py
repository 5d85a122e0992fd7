"""The port's tree SPH engine (``sidm_tpu_torch/ops/fused_sph.py``, on the
plain versions of T1-T3) against JAX's ``sidm_tpu/ops/fused_sph.py`` on
tests/test_fused_sph.py's six cases (``d`` density and ``h`` hydro against
the brute force, ``p`` periodic, ``m`` momentum, ``c`` the controller's
convergence, ``x`` mixed types with inactive gas) and ``k``,
tests/test_torch_sph.py's periodic comoving box (dark matter and padding
among the gas, warm state, 60 % active, the controller's 4 passes); JAX's
``FusedConfig(group_size=16, group_block=8, break_level=3)`` and a depth-6
tree, with JAX's outputs and ``ovf`` frozen in
tests/data/torch_tree_sph_golden.npz (``python -m tests.make_torch_golden
tree_sph``; the ``slow`` test reruns them). JAX's walk drops nothing on
these inputs (its ``ovf`` is 0, asserted), so the port is held to it:

* ``sph_density_fused``: ngb_sph equal; hsml equal where the controller
  does not run and to 2 ULPs where it does (``c``, 8 count passes; ``k``,
  4): its
  update h (des/cnt)^(1/3) takes a float32 pow, which PyTorch's CPU pow
  rounds one ULP off XLA's for about 1 % of the counts (1008 of 1e5
  random counts 1-199 at des 32), and each pass multiplies the last
  pass's h by it, so two passes' ULPs can add up (here 9 of the 400
  lengths differ, by at most 2 ULPs); the neighbour counts that follow
  such a difference are counted and must be 0; density, div_vel,
  curl_vel, dt_density and dt_hsml within 1e-5 of their largest (JAX
  sums float32 terms in float32, the port in float64, over 64-slot
  windows in another order);
* ``hydro_force_fused`` on JAX's density-pass particles: acc and dt_egy
  within 1e-5 of their largest;
* the same float64 brute-force bars as JAX's tests: density rtol 2e-5,
  div v and curl v rtol 1e-4 (atol 1e-5 of the largest), acc and dt_egy
  rtol 1e-4 (atol 2e-5 of the largest), momentum 1e-4, the controller's
  median |ngb - 32| <= 8, the mixed case's masks;
* the hydro walk's node hmax (``range_levels(tree, hmax)``) bit-equal to
  JAX's sparse-table range max on every node with particles;
* the hmax walk's coverage: every pair with r < max(h_i, h_j) (the
  minimum image in the box) lies in the segments of i's group, free and
  periodic (and the density walk's every r < h_i);
* T1's plain version (``range_walk_plain(use_hmax=)``, level by level)
  against a float64 brute-force acceptance of every frontier cell of every
  level, its hmax taken from the particles themselves: decisions equal
  except within 1e-5 of the threshold.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sidm_tpu_torch.ops import fused_sph as fs
from sidm_tpu_torch.ops.far_kernel import level_planes
from sidm_tpu_torch.ops.fused_force import IMAX, LEAF_CAP
from sidm_tpu_torch.ops.fused_range import (range_levels, range_walk_plain,
                                            segment_particles)
from sidm_tpu_torch.ops.sph import SphParams
from sidm_tpu_torch.ops.tree import build_octree
from sidm_tpu_torch.state import make_particles
from tests.make_torch_golden import (SPH_PARAMS, TREE_SPH_DEPTH,
                                     TREE_SPH_EPS, TREE_SPH_FIELDS,
                                     TREE_SPH_GOLDEN, TREE_SPH_TAGS,
                                     jax_tree_sph_ops, tree_sph_inputs)

torch.set_num_threads(2)
HYDRO_TAGS = tuple(t for t in TREE_SPH_TAGS if tree_sph_inputs(t)["hydro"])


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(TREE_SPH_GOLDEN))


def setup(tag):
    """(particles, tree, params, time, hydro active mask, box, iters,
    density active mask) of input ``tag``."""
    x = tree_sph_inputs(tag)
    p = make_particles(x["pos"], x["vel"], x["mass"], x["ptype"],
                       egy_spec=x["egy_spec"], pad_to_multiple=x["pad"],
                       device="cpu")
    p = dataclasses.replace(p, **{
        k: torch.as_tensor(v).to(getattr(p, k).dtype)
        for k, v in x["state"].items()})
    eps = torch.full_like(p.mass, TREE_SPH_EPS)
    tree = build_octree(p.pos, p.mass, eps, p.mass > 0, box=x["box"],
                        depth=TREE_SPH_DEPTH)
    prm = SphParams(**{**SPH_PARAMS, **x["params"]})
    active = torch.as_tensor(x["active"]) & p.valid
    return (p, tree, prm, torch.tensor(x["time"], dtype=torch.float32),
            active, x["box"], x["iters"],
            active if x["dens_active"] else p.valid)


def jax_particles(p, golden, tag):
    """p with JAX's density-pass fields."""
    return dataclasses.replace(p, **{
        f: torch.as_tensor(golden[f"{tag}_{f}"]) for f in TREE_SPH_FIELDS})


@pytest.fixture(scope="module")
def runs(golden):
    out = {}
    for tag in TREE_SPH_TAGS:
        p, tree, prm, t, active, box, iters, dact = setup(tag)
        q, dinfo = fs.sph_density_fused(p, p.pos, p.vel, tree, t, dact,
                                        prm, box=box, hsml_iters=iters)
        hyd = None
        if tag in HYDRO_TAGS:
            hyd = fs.hydro_force_fused(jax_particles(p, golden, tag), p.pos,
                                       p.vel, tree, t, active, prm, box=box)
        out[tag] = (p, tree, prm, t, active, box, q, dinfo, hyd)
    return out


def _of_largest(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("tag", TREE_SPH_TAGS)
def test_density_matches_jax(runs, golden, tag):
    p, tree, prm, t, active, box, q, dinfo, _ = runs[tag]
    assert not np.any(golden[f"{tag}_ovf"]), "JAX's walk dropped"
    assert dinfo["drops"] == 0
    got = {f: getattr(q, f).numpy() for f in TREE_SPH_FIELDS}
    want = {f: golden[f"{tag}_{f}"] for f in TREE_SPH_FIELDS}
    ulps = np.abs(got["hsml"] - want["hsml"]) / np.spacing(
        np.abs(want["hsml"]).astype(np.float32))
    flips = int(np.sum(got["ngb_sph"] != want["ngb_sph"]))
    errs = {f: _of_largest(got[f], want[f]) for f in
            ("density", "div_vel", "curl_vel", "dt_density", "dt_hsml")}
    print(f"{tag}: {dinfo['groups']} groups, {dinfo['walks']} walks, "
          f"{dinfo['pairs']} pairs; hsml ULPs max {ulps.max():.0f} "
          f"({int(np.sum(ulps > 0))} differ), ngb flips {flips}, {errs}")
    assert ulps.max() <= (2.0 if tree_sph_inputs(tag)["iters"] else 0.0)
    assert flips == 0
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("tag", HYDRO_TAGS)
def test_hydro_matches_jax(runs, golden, tag):
    *_, (acc, de, hinfo) = runs[tag]
    assert not np.any(golden[f"{tag}_ovf_h"]), "JAX's walk dropped"
    assert hinfo["drops"] == 0
    a_err = _of_largest(acc.numpy(), golden[f"{tag}_acc"])
    e_err = _of_largest(de.numpy(), golden[f"{tag}_dt_egy"])
    print(f"{tag}: {hinfo['pairs']} pairs, acc {a_err:.2e}, dt_egy "
          f"{e_err:.2e}")
    assert a_err <= 1e-5 and e_err <= 1e-5, (a_err, e_err)


@pytest.mark.parametrize("tag", HYDRO_TAGS)
def test_hmax_matches_jax(runs, golden, tag):
    p, tree, prm, *_ = runs[tag]
    q = jax_particles(p, golden, tag)
    hs = torch.where(q.is_gas, torch.clamp(q.hsml, min=prm.min_gas_hsml),
                     torch.zeros_like(q.hsml))[tree.perm]
    table = range_levels(tree, hs).table
    real = tree.node_count[:table.shape[0]] > 0
    np.testing.assert_array_equal(table[:, 3][real].numpy(),
                                  golden[f"{tag}_hmax"][real.numpy()])
    np.testing.assert_array_equal(table[:, 3][~real].numpy(), 0.0)


# ---- the float64 brute force of tests/test_fused_sph.py --------------------


def _w(u):
    u = np.clip(u, 0.0, 2.0)
    return np.where(u < 0.5, 1.0 - 6.0 * u * u * (1.0 - u),
                    2.0 * (1.0 - u) ** 3) * (8.0 / np.pi) * (u < 1)


def _dw(u):
    u = np.clip(u, 0.0, 2.0)
    return np.where(u < 0.5, -12.0 * u + 18.0 * u * u,
                    -6.0 * (1.0 - u) ** 2) * (8.0 / np.pi) * (u < 1)


def _pairs(x, box):
    d = x[:, None, :] - x[None, :, :]
    if box:
        d -= box * np.round(d / box)
    return d, np.sqrt(np.sum(d * d, axis=2))


def brute_density(x, v, m, h, box=0.0):
    d, r = _pairs(x, box)
    hi = h[:, None]
    inr = r < hi
    rho = np.sum(np.where(inr, m[None, :] * _w(r / hi) / hi ** 3, 0.0), 1)
    fac = np.where(inr & (r > 0), m[None, :] * _dw(r / hi) / hi ** 4
                   / np.maximum(r, 1e-30), 0.0)
    dv = v[:, None, :] - v[None, :, :]
    divv = -np.sum(fac * np.sum(d * dv, axis=2), 1)
    rot = np.sum(fac[..., None] * np.cross(d, dv), 1)
    return rho, divv, np.linalg.norm(rot, axis=1)


def brute_hydro(x, v, m, h, rho, egy, div_or, curl_or, dt, abv, box=0.0):
    rho = np.maximum(rho, 1e-30)
    pres = (5.0 / 3.0 - 1.0) * egy * rho
    cs = np.sqrt(5.0 / 3.0 * pres / rho)
    por2 = pres / rho ** 2
    fb = np.abs(div_or) / (np.abs(div_or) + curl_or
                           + 1e-4 * cs / np.maximum(h, 1e-30))
    d, r = _pairs(x, box)
    r2 = r * r
    okp = r > 0
    hi, hj = h[:, None], h[None, :]
    dwi = np.where((r < hi) & okp, _dw(r / hi) / hi ** 4, 0.0)
    dwj = np.where((r < hj) & okp, _dw(r / hj) / hj ** 4, 0.0)
    vdr = np.sum(d * (v[:, None, :] - v[None, :, :]), axis=2)
    hij = 0.5 * (hi + hj)
    mu = hij * vdr / (r2 + 0.01 * hij ** 2)
    visc = np.where(vdr < 0, (-abv * mu * 0.5 * (cs[:, None] + cs[None, :])
                              + 2 * abv * mu * mu)
                    / np.maximum(0.5 * (rho[:, None] + rho[None, :]), 1e-30)
                    * 0.5 * (fb[:, None] + fb[None, :]), 0.0)
    msum = 0.5 * (m[:, None] + m[None, :])
    rs = np.maximum(r, 1e-30)

    def lim(dw, dd):
        den = np.where(dw < 0, msum * 2 * dw * rs * np.maximum(dd, 1e-30),
                       -1e30)
        return np.where((vdr < 0) & (dd > 1e-30) & (dw < 0),
                        np.minimum(visc, vdr / den), visc)

    pp = 2 * np.sqrt(np.maximum(por2[:, None] * por2[None, :], 0))
    hfc = 0.5 * m[None, :] * ((pp + lim(dwi, dt[:, None])) * dwi
                              + (pp + lim(dwj, dt[None, :])) * dwj) / rs
    return (-np.sum(hfc[..., None] * d, 1), np.sum(0.5 * hfc * vdr, 1))


def _np64(*xs):
    return [x.numpy().astype(np.float64) for x in xs]


@pytest.mark.parametrize("tag", ["d", "p", "x"])
def test_density_matches_brute_force(runs, tag):
    p, tree, prm, t, active, box, q, _, _ = runs[tag]
    gas = p.is_gas.numpy()
    x, v, m, h = (a[gas] for a in _np64(p.pos, p.vel, p.mass, q.hsml))
    rho_b, divv_b, curl_b = brute_density(x, v, m, h, box)
    rho = q.density.numpy()[gas].astype(np.float64)
    np.testing.assert_allclose(rho, rho_b, rtol=2e-5)
    np.testing.assert_allclose(q.div_vel.numpy()[gas] * rho_b, divv_b,
                               rtol=1e-4, atol=1e-5 * np.abs(divv_b).max())
    np.testing.assert_allclose(q.curl_vel.numpy()[gas] * rho_b, curl_b,
                               rtol=1e-4, atol=1e-5 * curl_b.max())


@pytest.mark.parametrize("tag", ["h", "p"])
def test_hydro_matches_brute_force(runs, golden, tag):
    p, tree, prm, t, active, box, _, _, (acc, de, _) = runs[tag]
    q = jax_particles(p, golden, tag)
    x, v, m, h, rho, egy, dv, cv, ct = _np64(
        p.pos, p.vel, p.mass, q.hsml, q.density, q.egy_spec, q.div_vel,
        q.curl_vel, q.current_time)
    acc_b, de_b = brute_hydro(x, v, m, h, rho, egy, dv, cv,
                              2.0 * (float(t) - ct), 0.75, box)
    np.testing.assert_allclose(acc.numpy(), acc_b, rtol=1e-4,
                               atol=2e-5 * np.abs(acc_b).max())
    np.testing.assert_allclose(de.numpy(), de_b, rtol=1e-4,
                               atol=2e-5 * max(np.abs(de_b).max(), 1e-30))


def test_hydro_conserves_momentum(runs):
    p, *_, (acc, de, _) = runs["m"]
    m = p.mass.numpy().astype(np.float64)
    ma = m[:, None] * acc.numpy().astype(np.float64)
    assert np.abs(ma.sum(0)).max() / max(np.abs(ma).mean() * len(m),
                                         1e-30) < 1e-4
    assert np.isfinite(de.numpy()).all()


def test_controller_converges(runs):
    q = runs["c"][6]
    assert np.median(np.abs(q.ngb_sph.numpy() - 32)) <= 8
    assert q.density.numpy().min() > 0


def test_mixed_types_and_inactive_masking(runs):
    p, *_, (acc, de, _) = runs["x"]
    a = acc.numpy()
    assert (a[:32] == 0).all() and (a[128:] == 0).all()
    assert np.isfinite(a).all() and np.isfinite(de.numpy()).all()


# ---- the walks: coverage and T1's plain mode --------------------------------


def walk_setup(tag, use_hmax):
    """The driver's windows, boxes and walk (range_walk_plain) of input
    ``tag`` at the input's smoothing lengths: (tree, hs, pidx, gvalid,
    glo, ghi, pad, keys, nn, levels (each level's observed arguments))."""
    p, tree, prm, t, active, box, *_ = setup(tag)
    hs = torch.where(p.is_gas, p.hsml, torch.zeros_like(p.hsml))[tree.perm]
    pidx, gvalid = fs._gas_windows(tree, hs)
    gt = torch.where(gvalid[..., None], p.pos[tree.perm][pidx], 0.0)
    gh = torch.where(gvalid, hs[pidx], 0.0)
    glo, ghi, pad = fs._group_bbox(gt, gvalid & (gh > 0), gh, tree, box)
    levels = []
    keys, nn, ovf, _, _ = range_walk_plain(
        tree, range_levels(tree, hs if use_hmax else None), glo, ghi, pad,
        seg_cap=8192, box=box, use_hmax=use_hmax,
        on_level=lambda l, kw: levels.append((l, kw)))
    assert int(ovf) == 0
    return p, tree, hs, pidx, gvalid, glo, ghi, pad, keys, nn, levels, box


@pytest.mark.parametrize("tag,use_hmax", [("h", True), ("p", True),
                                          ("k", True), ("h", False),
                                          ("p", False)])
def test_walk_covers_pairs(tag, use_hmax):
    """Every pair r < max(h_i, h_j) (hmax walk) or r < h_i (density walk)
    of gas i and j lies in the segments of i's group."""
    p, tree, hs, pidx, gvalid, *_, keys, nn, _, box = walk_setup(tag,
                                                                 use_hmax)
    idx, val = segment_particles(keys, nn)
    x = p.pos[tree.perm].numpy().astype(np.float64)
    h = hs.numpy().astype(np.float64)
    _, r = _pairs(x, box)
    gas = h > 0
    need = (r < (np.maximum(h[:, None], h[None, :]) if use_hmax
                 else h[:, None])) & gas[:, None] & gas[None, :]
    missed = 0
    for g in range(pidx.shape[0]):
        cover = np.zeros(len(x), bool)
        cover[idx[g][val[g]].numpy()] = True
        for i in pidx[g][gvalid[g]].numpy():
            missed += int(np.sum(need[i] & ~cover))
    assert missed == 0
    assert int(need.sum()) > 0


@pytest.mark.parametrize("use_hmax", [False, True])
@pytest.mark.parametrize("tag", ["h", "p"])
def test_t1_plain_matches_brute_force_acceptance(tag, use_hmax):
    """Each level's frontier cells in range (segment, open or big keys of
    ``level_planes``) against a float64 test of the cell box (centre +-
    s_l/2) within max(pad, hmax + drift) (pad alone in the density walk)
    of the group box, hmax the largest h of the cell's particles."""
    (p, tree, hs, pidx, gvalid, glo, ghi, pad, keys, nn, levels,
     box) = walk_setup(tag, use_hmax)
    h = hs.numpy().astype(np.float64)
    start = tree.node_start.numpy()
    count = tree.node_count.numpy()
    off = tree.level_offsets
    tested = 0
    for l, kw in levels:
        _, seg, opn, big = level_planes(
            kw["fids"], kw["n_live"], kw["tbl"], kw["nl_real"], kw["s_l"],
            kw["glo"], kw["ghi"], kw["oac"], theta2=0.0, use_relative=False,
            leaf_cap=LEAF_CAP, last=kw["last"], range_walk=True, box=box,
            use_hmax=use_hmax, drift=kw["drift"])
        got = ((seg != IMAX) | (opn != IMAX) | (big != IMAX)).numpy()
        fids = kw["fids"].numpy()
        W = fids.shape[1]
        live = np.arange(W)[None, :] < np.minimum(kw["n_live"].numpy(),
                                                  W)[:, None]
        ids = np.where(live & (fids >= 0) & (fids < kw["nl_real"]), fids, -1)
        node = np.where(ids >= 0, off[l] + ids, 0)
        cnt = np.where(ids >= 0, count[node], 0)
        hm = np.array([h[s:s + c].max() if c else 0.0 for s, c in
                       zip(start[node].ravel(), cnt.ravel())]).reshape(
                           node.shape)
        ctr = tree.mac_rows[node.ravel(), 4:7].numpy().astype(
            np.float64).reshape(node.shape + (3,))
        half = 0.5 * float(tree.extent) / (1 << l)
        lo = glo.numpy().astype(np.float64)[:, None, :]
        hi = ghi.numpy().astype(np.float64)[:, None, :]
        if box:
            dd = ctr - 0.5 * (lo + hi)
            dd -= box * np.round(dd / box)
            gap = np.maximum(np.abs(dd) - 0.5 * (hi - lo) - half, 0.0)
        else:
            gap = np.maximum(np.maximum(lo - ctr, ctr - hi) - half, 0.0)
        d2 = np.sum(gap * gap, axis=2)
        eff = pad.numpy().astype(np.float64)[:, None]
        if use_hmax:
            eff = np.maximum(eff, hm + float(tree.drift))
        want = (cnt > 0) & (d2 <= eff * eff)
        diff = got != want
        assert not np.any(diff & (np.abs(d2 - eff * eff) > 1e-5 * eff * eff))
        tested += int(np.sum(cnt > 0))
    assert tested > 0


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """The committed golden file is what the JAX package gives now."""
    live = jax_tree_sph_ops()
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
