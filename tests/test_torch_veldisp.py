"""The port's velocity-dispersion pass (``sidm_tpu_torch/ops/veldisp.py``)
against JAX's ``sidm_tpu/ops/veldisp.py`` on ``veldisp_inputs`` (``o``:
the NFW halo of 4096, 64 of type 2; ``b``: a uniform periodic box), with
JAX's outputs frozen in tests/data/torch_veldisp_golden.npz (``python -m
tests.make_torch_golden veldisp``; the ``slow`` test reruns them):

* at JAX's cap of 96 rows a bucket (which drops rows for most of the
  halo's queries, as JAX does; the port counts them), a cold pass with
  every particle active and a warm pass from JAX's first-pass lengths with
  half of them active: ngb_vd equal, hsml_vd to 1e-6 relative (the
  squared distances' three-term sums round one ULP apart: JAX's XLA
  contracts them into fused multiply-adds on this CPU, as in
  tests/test_torch_neighbors.py), dens_vd and vel_disp to 2e-6 relative
  (JAX sums them in float32, the port in float64), the inactive and
  non-collisionless particles' fields unchanged bit for bit;
* at a cap grown past every bucket, against a float64 all-pairs sum in
  numpy at the port's radii: the neighbour counts equal (a neighbour
  within 1e-6 of the radius may fall either side: none here), dens_vd and
  vel_disp to 1e-5 relative, each radius the DesNumNgb-th neighbour
  distance times 1.0001 to 1e-6;

On the card (``gpu``): H4 (``csrc/hash_veldisp.cu``) against its plain
version, counts, need, clip and rows read equal and the float64 sums to
1e-12 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sidm_tpu_torch.kernels import sph_kernel
from sidm_tpu_torch.ops import veldisp as tv
from sidm_tpu_torch.state import make_particles
from tests.make_torch_golden import (VD, VD_FIELDS, VD_TAGS, VELDISP_GOLDEN,
                                     jax_veldisp_ops, veldisp_inputs)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(VELDISP_GOLDEN))


def _inputs(tag, golden, device="cpu"):
    """(p, pass-1 inputs, pass-2 inputs): pass 2 starts from JAX's pass-1
    particles."""
    box = VD_TAGS[tag]
    p, pos2, vel2, active = veldisp_inputs(make_particles, box)
    p = dataclasses.replace(p, **{f.name: getattr(p, f.name).to(device)
                                  for f in dataclasses.fields(p)})
    p1 = dataclasses.replace(p, **{
        f: torch.as_tensor(golden[f"{tag}1_{f}"]).to(device)
        for f in VD_FIELDS})
    act = torch.as_tensor(active).to(device) & p.valid
    return p, (p, p.pos, p.vel, p.valid), (
        p1, torch.as_tensor(pos2).to(device),
        torch.as_tensor(vel2).to(device), act)


@pytest.fixture(scope="module")
def passes(golden):
    out = {}
    for tag, box in VD_TAGS.items():
        _, a1, a2 = _inputs(tag, golden)
        for stage, args in ((1, a1), (2, a2)):
            out[tag, stage] = (args,) + tv.veldisp(
                *args, des_num_ngb=VD["k"], box=box)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("tag", list(VD_TAGS))
def test_veldisp_matches_jax(passes, golden, tag, stage):
    (p, _, _, active), q, info = passes[tag, stage]
    want = {f: golden[f"{tag}{stage}_{f}"] for f in VD_FIELDS}
    got = {f: getattr(q, f).numpy() for f in VD_FIELDS}
    ulp = int(np.sum(got["hsml_vd"] != want["hsml_vd"]))
    errs = {f: _rel(got[f], want[f]) for f in VD_FIELDS if f != "ngb_vd"}
    print(f"{tag}{stage}: queries {info['queries']}, buckets past cap 96 "
          f"{int(info['ngb_ovf'])} (need {int(info['need'])}), clipped "
          f"{int(info['lvl_clip'])}; hsml_vd differing {ulp}, rel errs "
          f"{errs}")
    np.testing.assert_array_equal(got["ngb_vd"], want["ngb_vd"])
    assert errs["hsml_vd"] <= 1e-6
    assert errs["dens_vd"] <= 2e-6 and errs["vel_disp"] <= 2e-6
    upd = (p.is_collisionless & active).numpy()
    assert info["queries"] == int(upd.sum())
    for f in VD_FIELDS:
        np.testing.assert_array_equal(got[f][~upd],
                                      getattr(p, f).numpy()[~upd])
    if tag == "o":      # JAX's cap drops rows on the halo: counted
        assert int(info["ngb_ovf"]) > 0 and int(info["need"]) > 96


def _brute_force(pos, vel, mass, ptype, valid, h, sel, box, k,
                 chunk: int = 256):
    """float64 all-pairs: (count, rho, vel_disp, k-th neighbour distance)
    of the queries ``sel`` at radii h, and whether a neighbour lies within
    1e-6 of a radius."""
    pos, vel, mass = (np.asarray(x, np.float64) for x in (pos, vel, mass))
    out = [[] for _ in range(5)]
    for c in range(0, sel.size, chunk):
        i = sel[c:c + chunk]
        d = pos[None, :, :] - pos[i, None, :]
        if box:
            d -= box * np.round(d / box)
        r = np.sqrt(np.sum(d * d, axis=2))
        hi = h[i, None]
        same = valid[None, :] & (ptype[None, :] == ptype[i, None])
        ok = same & (r < hi)
        u = r / hi
        w = np.where(u < 0.5, 1.0 - 6.0 * u * u * (1.0 - u),
                     2.0 * (1.0 - u) ** 3) * 8.0 / np.pi * ok
        cnt = ok.sum(1)
        vm = (ok @ vel) / cnt[:, None]
        v2 = (ok @ (vel * vel)) / cnt[:, None]
        disp = np.sqrt(np.maximum(np.sum(v2 - vm * vm, 1), 0.0))
        kth = np.partition(np.where(same, r, np.inf), k - 1,
                           axis=1)[:, k - 1]
        tie = np.any(same & (np.abs(r / hi - 1.0) < 1e-6), axis=1)
        for o, x in zip(out, (cnt, (w @ mass) / h[i] ** 3, disp, kth, tie)):
            o.append(x)
    return [np.concatenate(o) for o in out]


@pytest.mark.parametrize("tag", list(VD_TAGS))
def test_grown_cap_matches_brute_force(golden, tag):
    box = VD_TAGS[tag]
    _, _, (p, pos, vel, active) = _inputs(tag, golden)
    q, info = tv.veldisp(p, pos, vel, active, des_num_ngb=VD["k"], box=box,
                         cap=VD["n"])
    assert int(info["ngb_ovf"]) == 0 and int(info["lvl_clip"]) == 0
    sel = info["sel"].numpy()
    h = q.hsml_vd.numpy().astype(np.float64)
    cnt, rho, disp, kth, tie = _brute_force(
        pos.numpy(), vel.numpy(), p.mass.numpy(), p.ptype.numpy(),
        p.valid.numpy(), h, sel, box, VD["k"])
    flips = q.ngb_vd.numpy()[sel] != cnt
    print(f"{tag}: {sel.size} queries, count flips {int(flips.sum())} "
          f"(near the radius {int(tie.sum())}), rho "
          f"{_rel(q.dens_vd[sel], rho):.2e}, disp "
          f"{_rel(q.vel_disp[sel], disp):.2e}, h / (kth 1.0001) "
          f"{_rel(h[sel], kth * 1.0001):.2e}")
    assert not np.any(flips & ~tie)
    assert _rel(q.dens_vd.numpy()[sel], rho) <= 1e-5
    assert _rel(q.vel_disp.numpy()[sel], disp) <= 1e-5
    assert _rel(h[sel], kth * 1.0001) <= 1e-6


def test_moments_and_kernel_weights():
    """``moments`` gives JAX's formulas from the float64 sums; the plain
    sums' W is ``kernels.sph_kernel``."""
    s = tv.VdSums(cnt=torch.tensor([3, 0], dtype=torch.int32),
                  rho=torch.tensor([2.5, 0.0], dtype=torch.float64),
                  sv=torch.tensor([[3.0, 0.0, -3.0], [0.0, 0.0, 0.0]],
                                  dtype=torch.float64),
                  sv2=torch.tensor([14.0, 0.0], dtype=torch.float64),
                  need=torch.zeros(2, dtype=torch.int32),
                  clip=torch.zeros(2, dtype=torch.bool),
                  scanned=torch.zeros(2, dtype=torch.int64))
    rho, disp = tv.moments(s, torch.float32)
    # 14/3 - (1 + 0 + 1) = 8/3
    np.testing.assert_allclose(disp.numpy(), [np.sqrt(8.0 / 3.0), 0.0],
                               rtol=1e-7)
    np.testing.assert_array_equal(rho.numpy(), [2.5, 0.0])
    u = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0])
    np.testing.assert_allclose(
        sph_kernel(u).numpy(),
        8.0 / np.pi * np.array([1.0, 1.0 - 6 * 0.0625 * 0.75, 0.25,
                                2 * 0.25 ** 3, 0.0]), rtol=1e-6)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [8, 96, 4096])
@pytest.mark.parametrize("tag", list(VD_TAGS))
def test_veldisp_kernel_matches_plain_on_card(cuda, golden, tag, cap):
    box = VD_TAGS[tag]
    _, _, (p, pos, vel, active) = _inputs(tag, golden, cuda)
    _, info = tv.veldisp_plain(p, pos, vel, active, des_num_ngb=VD["k"],
                               box=box, cap=cap)
    table, sel = info["table"], info["sel"]
    args = (table, pos[sel].contiguous(), p.ptype[sel].contiguous(),
            info["knn"].h.contiguous())
    n0 = tv.veldisp_sums.launches
    k = tv.veldisp_sums(*args, cap=cap)
    assert tv.veldisp_sums.launches == n0 + 1
    s = tv.veldisp_sums_plain(*args, cap=cap)
    for f in ("cnt", "need", "clip", "scanned"):
        assert torch.equal(getattr(k, f), getattr(s, f).to(
            getattr(k, f).dtype)), f
    # sum v may cancel: its error against the sum of |v|
    scale = {"rho": s.rho, "sv2": s.sv2,
             "sv": torch.sqrt(s.sv2 * s.cnt.double())[:, None]}
    for f in ("rho", "sv", "sv2"):
        a, b = getattr(k, f), getattr(s, f)
        err = torch.max(torch.abs(a - b) / torch.clamp(scale[f], min=1e-300))
        assert float(err) <= 1e-12, (f, float(err))


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """This file's part of the committed golden file is what the JAX
    package gives now."""
    live = jax_veldisp_ops()
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
