"""The free-space TreePM split of an isolated run (``PMVacuum``) in the
port, on the CPU, against the JAX package's outputs frozen in
tests/data/torch_vacuum_golden.npz (tests/make_torch_golden.py
``vacuum``):

* the free-space mesh (``ops/pm.py`` ``build_pm_kernel_free``,
  ``pm_accel_free``) on tests/test_pm_vacuum.py's two inputs: the split
  constants and the region equal, acceleration and potential within 1e-5
  of JAX's largest, ``pot_self`` within 1e-5 of it;
* the walk kernels' free-space mode in their plain versions
  (``fused_force.classify``, ``far_tile_pbc``, ``near_tile`` with ``pbc``
  = (0, alpha, rcut)) against JAX's ``_classify``, ``_far_tile_pbc`` and
  ``_near_tile`` with that pbc on tests/test_torch_periodic_walk.py's
  random inputs: the planes equal (both openings, the last level and
  not), the far tile within 2e-5 and the near tile within 1e-5 of JAX's
  largest magnitude;
* the TreePM identity of tests/test_pm_vacuum.py: the port's walk in its
  free-space mode (geometric opening at theta 1e-3, which opens every cell
  the cut keeps) plus its mesh against JAX's direct sum: p99 relative
  error no worse than JAX's own identity's p99 x 1.05 (JAX's brute-force
  short range, frozen); that test's bar is 2e-3, which neither package
  meets on this input (4.36e-3, ROADMAP.md C.9: the screened force cut at
  rcut, alpha rcut = 2.25 at PMRcutFac 4.5 and PMAsmth 1.25, where
  S(rcut) = 1.75e-2, not the clamp, which moves no particle);
* what sets that identity's error: no particle is clamped into the
  region, and a cut at ``PMRcutFac`` 6 (alpha rcut = 3) lowers it by more
  than a third;
* the potential energy of the split (mesh plus the walk's screened pairs,
  the mesh's self term removed) within 1e-2 of JAX's direct sum's, that
  test's bar;
* the particles the region's clamp moves are counted (ROADMAP C.22).
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.ops import pm
from sidm_tpu_torch.ops.far_list import far_list
from sidm_tpu_torch.ops.fused_force import classify, far_tile_pbc, near_tile
from sidm_tpu_torch.ops.near_kernel import near_level
from sidm_tpu_torch.ops.wq_force import wq_gravity
from tests.make_torch_golden import (TILE, VAC_MESH, VACUUM_GOLDEN,
                                     tile_inputs, vacuum_mesh_inputs)

torch.set_num_threads(2)
VPBC = (0.0, TILE["alpha"], TILE["rcut"])
OPEN_THETA = 1e-3


@pytest.fixture(scope="module")
def golden():
    with np.load(VACUUM_GOLDEN) as z:
        return {k: z[k] for k in z.files if not k.startswith("vs")}


@pytest.fixture(scope="module")
def t():
    return {k: torch.tensor(v) for k, v in tile_inputs().items()}


def close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), \
        np.abs(a - b).max() / np.abs(b).max()


def kernel(k, **changes):
    v = dict(VAC_MESH, **changes)
    pos, mass, eps, center, radius = vacuum_mesh_inputs(k)
    kern = pm.build_pm_kernel_free(center, radius, n=v["mesh"],
                                   asmth=v["asmth"], rcut_fac=v["rcut_fac"])
    return kern, torch.tensor(pos), torch.tensor(mass), torch.tensor(eps)


@pytest.mark.parametrize("k", [1, 2])
def test_pm_accel_free_matches_jax(golden, k):
    kern, pos, mass, _ = kernel(k)
    for f in ("alpha", "rcut", "box"):
        assert getattr(kern, f) == pytest.approx(float(golden[f"vm{k}_{f}"]),
                                                 rel=1e-12)
    assert np.array_equal(kern.origin.numpy(), golden[f"vm{k}_origin"])
    want = float(golden[f"vm{k}_pot_self"])
    assert abs(kern.pot_self - want) <= 1e-5 * abs(want)
    acc, pot = pm.pm_accel_free(kern, pos, mass, with_potential=True)
    close(acc, golden[f"vm{k}_acc"], 1e-5)
    close(pot, golden[f"vm{k}_pot"], 1e-5)
    acc0, pot0 = pm.pm_accel_free(kern, pos, mass)
    assert torch.equal(acc0, acc) and not pot0.any()


def test_count_clamped_particles():
    """ROADMAP C.22: the particles of mass > 0 that pm_accel_free's clamp
    moves into the region are counted (one far outside, one just past the
    clamp plane; one massless outside is not); none of the input's own."""
    kern, pos, mass, _ = kernel(2)
    h = kern.box / kern.n
    pos, mass = pos.clone(), mass.clone()
    o = kern.origin
    pos[0] = o + torch.tensor([kern.box * 2.0, 0.5 * kern.box, 0.0])
    pos[1] = o + torch.tensor([0.5 * kern.box, 1.5 * h, 0.5 * kern.box])
    pos[2] = o - 3.0 * kern.box
    mass[2] = 0.0
    assert int(pm.count_clamped(kern, pos, mass)) == 2
    assert int(pm.count_clamped(kern, *kernel(2)[1:3])) == 0


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("rel", [False, True])
def test_classify_free_space_matches_jax(golden, t, last, rel):
    planes = classify(t["rows"], t["glo"], t["ghi"], t["oac"], t["s_l"],
                      0.25, rel, 16, last, VPBC)
    for name, pl in zip(("far", "seg", "opn", "big"), planes):
        want = golden[f"vcl{int(last)}{int(rel)}_{name}"]
        assert np.array_equal(pl.numpy(), want), name
    # the open walk's classification with the cut: the cut drops some
    # live cells, and the dead group (an inverted box) reaches nothing
    opened = classify(t["rows"], t["glo"], t["ghi"], t["oac"], t["s_l"],
                      0.25, rel, 16, last, None)
    dropped = 0
    for a, b in zip(planes, opened):
        assert bool((a <= b).all())
        dropped += int(b.sum()) - int(a.sum())
    assert dropped > 0
    assert not any(bool(pl[-1].any()) for pl in planes)


@pytest.mark.parametrize("need_pot", [False, True])
def test_far_tile_free_space_matches_jax(golden, t, need_pot):
    far = torch.tensor(golden["vcl00_far"])
    rows = t["rows"].clone()
    rows[..., 3] = torch.where(far, rows[..., 3],
                               torch.zeros_like(rows[..., 3]))
    trq = torch.where(far, t["trq"], torch.zeros_like(t["trq"]))
    da, dp = far_tile_pbc(rows, trq, t["xr"], t["te"], VPBC, need_pot)
    close(da, golden[f"vft{int(need_pot)}_acc"], 2e-5)
    if need_pot:
        close(dp, golden["vft1_pot"], 2e-5)


@pytest.mark.parametrize("need_pot", [False, True])
def test_near_tile_free_space_matches_jax(golden, t, need_pot):
    da, dp = near_tile(t["ent"], t["ppos"], t["pmass"], t["peps"], t["xr"],
                       t["te"], need_pot, VPBC)
    close(da, golden[f"vnt{int(need_pot)}_acc"], 1e-5)
    if need_pot:
        close(dp, golden["vnt1_pot"], 1e-5)


def split(k, need_pot, **changes):
    """The port's TreePM split of input k: (mesh acc, mesh pot, walk acc,
    walk pot, the kernel, mass), the walk's launch counters unchanged on
    the CPU."""
    kern, pos, mass, eps = kernel(k, **changes)
    n0 = (far_list.vacuum_launches, near_level.vacuum_launches)
    al, pl = pm.pm_accel_free(kern, pos, mass, with_potential=need_pot)
    a_s, p_s, info = wq_gravity(pos, mass, eps, torch.zeros(len(mass)),
                                theta=OPEN_THETA, opening=0,
                                need_pot=need_pot, return_info=True,
                                pbc=(0.0, kern.alpha, kern.rcut))
    assert (far_list.vacuum_launches, near_level.vacuum_launches) == n0
    assert sum(int(info[f]) for f in ("ovf_open", "ovf_big",
                                      "ovf_items")) == 0
    return al, pl, a_s, p_s, kern, mass


def identity_p99(golden, **changes):
    """p99 of the split's relative force error on input 1 against JAX's
    direct sum, and the kernel."""
    al, _, a_s, _, kern, _ = split(1, False, **changes)
    acc = (al + a_s).double().numpy()
    ad = golden["vm1_dacc"].astype(np.float64)
    rel = np.linalg.norm(acc - ad, axis=1) / np.maximum(
        np.linalg.norm(ad, axis=1), 1e-20)
    return np.percentile(rel, 99), kern


def test_vacuum_treepm_matches_direct(golden):
    p99, _ = identity_p99(golden)
    jax_p99 = float(golden["vm1_jax_p99"])
    # both beside test_pm_vacuum.py's 2e-3 (ROADMAP.md C.9): 4.36e-3
    assert p99 <= 1.05 * jax_p99, (p99, jax_p99)
    assert 2e-3 < jax_p99 < 5e-3


@pytest.mark.parametrize("case", ["clamp", "rcut6"])
def test_vacuum_identity_error_comes_from_the_cut(golden, case):
    if case == "clamp":
        kern, pos, _, _ = kernel(1)
        h = kern.box / kern.n
        q = pos - kern.origin
        assert bool(((q >= 1.6 * h) & (q <= kern.box - 1.6 * h)).all())
        return
    p99, kern = identity_p99(golden, rcut_fac=6.0)
    assert kern.alpha * kern.rcut == pytest.approx(3.0)
    assert p99 < float(golden["vm1_jax_p99"]) / 1.5, p99


def test_vacuum_pm_potential_total_energy(golden):
    _, pl, _, p_s, kern, mass = split(2, True)
    pot = (pl - mass * kern.pot_self + p_s).double().numpy()
    m = mass.double().numpy()
    e_pm = 0.5 * float(np.sum(m * pot))
    e_d = 0.5 * float(np.sum(m * golden["vm2_dpot"].astype(np.float64)))
    assert abs(e_pm - e_d) / abs(e_d) < 1e-2
    assert float(golden["vm2_jax_energy"]) < 1e-2


@pytest.mark.slow
def test_golden_is_current_jax_output():
    """The committed golden file is what the JAX package gives now (its
    steps' outputs included)."""
    from tests.make_torch_golden import jax_vacuum
    live = jax_vacuum()
    with np.load(VACUUM_GOLDEN) as z:
        assert sorted(live) == sorted(z.files)
        for k, v in live.items():
            np.testing.assert_array_equal(v, z[k], err_msg=k)
