"""The port's SPH pass (``sidm_tpu_torch/ops/sph.py``) against JAX's
``sidm_tpu/ops/sph.py`` on tests/test_sph.py's four inputs (``d``
density, ``s`` symmetry, ``c`` the clump, ``v`` the converging flows; cap
128) and a periodic comoving box (``x``: a clump across its corner, a
fifth of the particles dark matter, padding, warm smoothing lengths, 60 %
active), with JAX's outputs frozen in tests/data/torch_sph_golden.npz
(``python -m tests.make_torch_golden sph``; the ``slow`` test reruns
them). The ops read JAX's fixed cap, so they drop JAX's rows:

* ``sph_density`` (H1 and H5's plain version): ngb_sph equal, hsml to 2
  ULPs (the squared distances' sums round one ULP apart where JAX's XLA
  contracts them into fused multiply-adds on this CPU, as in
  tests/test_torch_neighbors.py, and PyTorch's float32 square root on
  the CPU rounds a near-tie one ULP off the correctly rounded root that
  numpy and XLA give: in ``x`` one k-th distance of 0.093738884 squared,
  whose root 0.3061680645 lies 1.5e-8 from both neighbouring floats; the
  1.0001 pad then makes it 2 ULPs of h), density to 1e-5 relative, div_vel,
  curl_vel, dt_density and dt_hsml within 1e-5 of their largest (JAX sums
  in float32, the port in float64), the other particles' fields
  unchanged;
* ``hydro_force`` (H6's plain version): acc and dt_egy within 1e-5 of
  their largest, its overflowed queries JAX's count;
* test_sph.py's own physical bars on the port: the density against a
  brute-force sum (rtol 1e-4), momentum conserved (1e-4), the clump pushed
  outward (> 0.85 of it), viscosity heating the converging flows;
* at a cap past every bucket, the periodic comoving box's density
  against a float64 minimum-image sum at the port's radii.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sidm_tpu_torch.kernels import sph_kernel, sph_kernel_deriv
from sidm_tpu_torch.ops import sph as ts
from sidm_tpu_torch.state import make_particles
from tests.make_torch_golden import (SPH_DENS_FIELDS, SPH_GOLDEN, SPH_PARAMS,
                                     SPH_TAGS, jax_sph_ops, sph_inputs)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(SPH_GOLDEN))


def sph_setup(tag, device="cpu", cap=None):
    """(p, time, active, SphParams, box) of input ``tag`` on ``device``."""
    x = sph_inputs(tag)
    p = make_particles(x["pos"], x["vel"], x["mass"], x["ptype"],
                       egy_spec=x["egy_spec"], pad_to_multiple=x["pad"],
                       device=device)
    p = dataclasses.replace(p, **{
        k: torch.as_tensor(v).to(device=device, dtype=getattr(p, k).dtype)
        for k, v in x["state"].items()})
    t = torch.tensor(x["time"], dtype=torch.float32, device=device)
    active = torch.as_tensor(x["active"]).to(device) & p.valid
    changes = dict(x["params"], **({"cap": cap} if cap else {}))
    return p, t, active, ts.SphParams(**{**SPH_PARAMS, **changes}), x["box"]


@pytest.fixture(scope="module")
def passes():
    out = {}
    for tag in SPH_TAGS:
        p, t, active, prm, box = sph_setup(tag)
        q, dinfo = ts.sph_density(p, p.pos, p.vel, t, active, prm, box=box)
        acc, de, hinfo = ts.hydro_force(q, p.pos, p.vel, t, active, prm,
                                        dinfo["table"], box=box)
        out[tag] = (p, active, q, dinfo, acc, de, hinfo)
    return out


def _of_largest(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("tag", SPH_TAGS)
def test_sph_matches_jax(passes, golden, tag):
    p, active, q, dinfo, acc, de, hinfo = passes[tag]
    got = {f: getattr(q, f).numpy() for f in SPH_DENS_FIELDS}
    want = {f: golden[f"{tag}_{f}"] for f in SPH_DENS_FIELDS}
    ulps = np.abs(got["hsml"] - want["hsml"]) / np.spacing(
        np.abs(want["hsml"]).astype(np.float32))
    errs = {f: _of_largest(got[f], want[f]) for f in
            ("div_vel", "curl_vel", "dt_density", "dt_hsml")}
    rho_rel = float(np.max(np.abs(got["density"] - want["density"])
                           / np.maximum(np.abs(want["density"]), 1e-30)))
    a_err = _of_largest(acc.numpy(), golden[f"{tag}_acc"])
    e_err = _of_largest(de.numpy(), golden[f"{tag}_dt_egy"])
    print(f"{tag}: {dinfo['queries']} density and {hinfo['queries']} hydro "
          f"queries, need {int(dinfo['need'])}/{int(hinfo['need'])}, "
          f"overflowed {int(dinfo['ngb_ovf'])}/{int(hinfo['ngb_ovf'])} "
          f"(JAX {int(golden[f'{tag}_ovf'])}/{int(golden[f'{tag}_ovf_h'])}"
          f"); hsml ULPs max {ulps.max():.0f} ({int(np.sum(ulps > 0))} "
          f"differ), density rel {rho_rel:.2e}, {errs}, acc {a_err:.2e}, "
          f"dt_egy {e_err:.2e}")
    np.testing.assert_array_equal(got["ngb_sph"], want["ngb_sph"])
    assert ulps.max() <= 2.0
    assert rho_rel <= 1e-5
    assert max(errs.values()) <= 1e-5, errs
    assert a_err <= 1e-5 and e_err <= 1e-5, (a_err, e_err)
    assert int(hinfo["ngb_ovf"]) == int(golden[f"{tag}_ovf_h"])
    upd = (p.is_gas & active).numpy()
    for f in SPH_DENS_FIELDS:
        np.testing.assert_array_equal(got[f][~upd],
                                      getattr(p, f).numpy()[~upd])
    np.testing.assert_array_equal(acc.numpy()[~upd], 0.0)
    np.testing.assert_array_equal(de.numpy()[~upd], p.dt_egy.numpy()[~upd])


def _brute_density(pos, vel, mass, h, box=0.0):
    """float64 all-pairs rho, divv and neighbour counts at radii h, and
    whether a neighbour lies within 1e-6 of a radius."""
    pos, vel, mass = (np.asarray(x, np.float64) for x in (pos, vel, mass))
    d = pos[:, None, :] - pos[None, :, :]
    if box:
        d -= box * np.round(d / box)
    r = np.sqrt(np.sum(d * d, axis=2))
    hi = np.asarray(h, np.float64)[:, None]
    u = r / hi
    ok = u < 1
    w = np.where(u < 0.5, 1.0 - 6.0 * u * u * (1.0 - u),
                 2.0 * (1.0 - u) ** 3) * 8.0 / np.pi * ok / hi ** 3
    dw = np.where(u < 0.5, -12.0 * u + 18.0 * u * u,
                  -6.0 * (1.0 - u) ** 2) * 8.0 / np.pi * ok / hi ** 4
    dv = vel[:, None, :] - vel[None, :, :]
    fac = mass[None, :] * dw / np.maximum(r, 1e-30) * (r > 0)
    divv = -np.sum(fac * np.sum(d * dv, axis=2), axis=1)
    tie = np.any(np.abs(u - 1.0) < 1e-6, axis=1)
    return w @ mass, divv, ok.sum(1), tie


def test_density_matches_brute_force(passes):
    """test_sph.py's bar: rho to 1e-4, div v rho to 1e-3 (atol 1e-5), the
    neighbour counts within 2 of DesNumNgb."""
    p, _, q, _, _, _, _ = passes["d"]
    rho_ref, divv_ref, _, _ = _brute_density(p.pos.numpy(), p.vel.numpy(),
                                             p.mass.numpy(), q.hsml.numpy())
    rho = q.density.numpy()
    np.testing.assert_allclose(rho, rho_ref, rtol=1e-4)
    np.testing.assert_allclose(q.div_vel.numpy() * rho, divv_ref, rtol=1e-3,
                               atol=1e-5)
    assert (np.abs(q.ngb_sph.numpy() - 32) <= 2).all()


def test_hydro_force_conserves_momentum(passes):
    """test_sph.py's bar: |sum m a| below 1e-4 of n <|m a|>."""
    p, _, _, _, acc, de, _ = passes["s"]
    m = p.mass.numpy().astype(np.float64)
    ma = m[:, None] * acc.numpy().astype(np.float64)
    net = np.abs(ma.sum(0)).max()
    assert net / max(np.abs(ma).mean() * len(m), 1e-30) < 1e-4
    assert np.isfinite(de.numpy()).all()


def test_hydro_force_pushes_clump_apart(passes):
    """test_sph.py's bar: more than 85 % of the dense clump accelerates
    away from its centre."""
    p, _, _, _, acc, _, _ = passes["c"]
    d = p.pos.numpy()[:64].astype(np.float64) - 0.5
    a = acc.numpy()[:64]
    rad = (a * d).sum(1) / np.maximum(np.linalg.norm(d, axis=1), 1e-9)
    assert (rad > 0).mean() > 0.85


def test_viscosity_heats_converging_flows(passes):
    """test_sph.py's bar: du/dt > 0 on average near the interface."""
    p, _, _, _, _, de, _ = passes["v"]
    mid = np.abs(p.pos.numpy()[:, 0] - 0.5) < 0.1
    assert de.numpy()[mid].mean() > 0


def test_grown_cap_periodic_comoving_matches_brute_force():
    """The periodic comoving box at a cap past every bucket: no bucket
    read past it, no clipped level; at the port's radii the counts equal a
    float64 minimum-image sum's (ties within 1e-6 of a radius excepted:
    none here) and rho within 1e-5 relative."""
    p, t, active, prm, box = sph_setup("x", cap=4096)
    q, info = ts.sph_density(p, p.pos, p.vel, t, active, prm, box=box)
    assert int(info["ngb_ovf"]) == 0 and int(info["lvl_clip"]) == 0
    gas = p.is_gas.numpy()
    sel = info["sel"].numpy()
    rho, _, cnt, tie = _brute_density(p.pos.numpy()[gas], p.vel.numpy()[gas],
                                      p.mass.numpy()[gas],
                                      q.hsml.numpy()[gas], box)
    idx = np.searchsorted(np.flatnonzero(gas), sel)
    got = info["sums"]
    assert not np.any((got.cnt.numpy() != cnt[idx]) & ~tie[idx])
    np.testing.assert_allclose(q.density.numpy()[sel], rho[idx], rtol=1e-5)


def test_kernel_derivative():
    """``sph_kernel_deriv`` is dW/du of ``sph_kernel`` (central
    differences) and JAX's closed form at its knots."""
    u = torch.linspace(0.02, 0.98, 49, dtype=torch.float64)
    num = (sph_kernel(u + 1e-6) - sph_kernel(u - 1e-6)) / 2e-6
    np.testing.assert_allclose(sph_kernel_deriv(u).numpy(), num.numpy(),
                               rtol=1e-5, atol=1e-5)
    k = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0, 1.5])
    np.testing.assert_allclose(
        sph_kernel_deriv(k).numpy(),
        8.0 / np.pi * np.array([0.0, -3.0 + 18 * 0.0625, -1.5,
                                -6 * 0.0625, 0.0, 0.0]), rtol=1e-6)


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """The committed golden file is what the JAX package gives now."""
    live = jax_sph_ops()
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
