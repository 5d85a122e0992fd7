"""The port's DSMC foundation vs the JAX package: ``rng.py``, the
cross-section math of ``sidm_common.py``, the pair hash and Gumbel noise
of ``ops/sidm_tree.py``, the conflict resolver of ``ops/sidm.py``, the
hsml seed and ``tree_hsml_init_fused`` of ``ops/fused_range.py`` and the
pre-gate of ``_tree_sidm_prep``.

The JAX side is frozen in tests/data/torch_sidm_golden.npz
(tests/make_torch_golden.py ``sidm``); the ``slow`` test reruns it and
holds the file to it. Held exactly: the run and step keys, the uniforms'
bits, the pair hash, the accepted set of the resolver, the neighbour
counts of the hsml init, the pre-gate's scan set. Floats: directions and
the cross sections to rtol 1e-6, the Gumbel noise to rtol and atol 1e-6
(``cos``, ``sin``, ``log`` and ``pow`` may round one ULP apart in XLA and
PyTorch), the smoothing lengths to rtol 1e-6 (the seed's ``pow``, ten
controller steps).
"""

import dataclasses

import numpy as np
import pytest
import torch

from sidm_tpu_torch import rng
from sidm_tpu_torch.ops import fused_range as tfr
from sidm_tpu_torch.ops.fused_force import default_depth
from sidm_tpu_torch.ops.sidm import SidmParams, resolve_conflicts_compact
from sidm_tpu_torch.ops.sidm_tree import (mix32, nanmedian, pair_gumbel,
                                          tree_sidm_prep)
from sidm_tpu_torch.ops.tree import build_octree
from sidm_tpu_torch.sidm_common import sigma_v_product
from sidm_tpu_torch.state import make_particles
from tests.make_torch_golden import (LIST_N, SIDM_GOLDEN, SIDM_SCATTER,
                                     SIDM_SEED, SIDM_SIGMA,
                                     SIDM_STEP_NUMBERS, jax_sidm_ops,
                                     list_inputs, sidm_pending,
                                     sidm_resolve_inputs, sidm_rng_inputs)

torch.set_num_threads(2)

# the keys of the golden file this test file holds (the rest are
# tests/test_torch_sidm_lists.py's)
KEYS = ("rng_", "sigv_", "mix32_", "gumbel_", "resolve_", "hsml_", "prep_",
        "h_eff_all")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(SIDM_GOLDEN))


@pytest.fixture(scope="module")
def halo():
    pos, vel, mass, eps, _ = list_inputs()
    p = make_particles(pos, vel, mass, np.ones(LIST_N, np.int32),
                       pad_to_multiple=LIST_N)
    tree = build_octree(p.pos, p.mass, torch.tensor(eps), p.valid,
                        depth=default_depth(LIST_N))
    return p, tree


def test_run_and_step_keys_exact(golden):
    root = rng.run_key(*SIDM_SEED)
    assert root == tuple(int(x) for x in golden["rng_root"])
    got = np.array([rng.step_key(root, s) for s in SIDM_STEP_NUMBERS],
                   np.uint32)
    np.testing.assert_array_equal(got, golden["rng_step_keys"])


def test_uniforms_exact_and_directions(golden):
    pid, _, _, _ = sidm_rng_inputs()
    key = rng.step_key(rng.run_key(*SIDM_SEED), 7)
    pid_t = torch.tensor(pid.astype(np.int64))
    np.testing.assert_array_equal(
        rng.particle_uniforms(key, pid_t, 4).numpy(), golden["rng_uniforms"])
    d = rng.random_directions(key, pid_t).numpy()
    np.testing.assert_allclose(d, golden["rng_dirs"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-6)


def test_mul32_wraps_like_uint32():
    a = np.array([0, 1, 0xFFFFFFFF, 0x9E3779B9, 12345678], np.uint64)
    for b in (0x9E3779B9, 0xFFFFFFFF, 0x7FEB352D):
        want = (a * np.uint64(b)) & np.uint64(0xFFFFFFFF)
        got = rng.mul32(torch.tensor(a.astype(np.int64)), b).numpy()
        np.testing.assert_array_equal(got.astype(np.uint64), want)


@pytest.mark.parametrize("cs_type", range(5))
def test_sigma_v_product(golden, cs_type):
    _, rv, _, _ = sidm_rng_inputs()
    sg = SIDM_SIGMA
    t = torch.tensor(1.0)
    got = sigma_v_product(torch.tensor(rv), t, torch.tensor(sg["sigma_co"]),
                          cs_type, sg["yukawa_velocity"], sg["vel_scale"],
                          sg["pow_law"], False)
    np.testing.assert_allclose(got.numpy(), golden[f"sigv_{cs_type}"],
                               rtol=1e-6)


@pytest.mark.parametrize("salt", [0, 5, 2 ** 32 - 1])
def test_pair_hash_exact_and_gumbel(golden, salt):
    """The hash bits exactly; the Gumbel noise (two logs) to rtol 1e-6 and
    atol 1e-6: near -log(-log(u)) = 0 one ULP of the inner log is ~1e-7
    absolute."""
    _, _, ij, _ = sidm_rng_inputs()
    i, j = (torch.tensor(x.astype(np.int64)) for x in ij)
    np.testing.assert_array_equal(mix32(i, j, salt).numpy().astype(
        np.uint32), golden[f"mix32_{salt}"])
    np.testing.assert_allclose(pair_gumbel(i, j, salt).numpy(),
                               golden[f"gumbel_{salt}"], rtol=1e-6,
                               atol=1e-6)


def test_resolve_conflicts_exact(golden):
    prop = sidm_resolve_inputs()
    acc, rounds, dropped, _, _ = resolve_conflicts_compact(
        torch.tensor(prop), prop.shape[0])
    np.testing.assert_array_equal(acc.numpy(), golden["resolve_accepted"])
    assert rounds > 1 and dropped == 0
    # conflicts occurred: fewer accepted than proposed
    assert int(acc.sum()) < int((prop >= 0).sum())
    print(f"resolver: {int((prop >= 0).sum())} proposals, "
          f"{int(acc.sum())} accepted in {rounds} rounds")


def test_resolve_conflicts_counts_the_cap():
    """JAX drops proposers past its cap silently (ROADMAP C.3): the port
    takes the same first ``cap`` and counts the rest."""
    prop = torch.tensor(sidm_resolve_inputs())
    cap = 100
    acc, _, dropped, _, _ = resolve_conflicts_compact(prop, prop.shape[0],
                                                      cap=cap)
    first = torch.nonzero(prop >= 0).flatten()[:cap]
    cut = torch.full_like(prop, -1)
    cut[first] = prop[first]
    ref = resolve_conflicts_compact(cut, prop.shape[0])[0]
    assert torch.equal(acc, ref)
    assert dropped == int((prop >= 0).sum()) - cap


def test_nanmedian_is_jax_median():
    x = torch.tensor([3.0, float("nan"), 1.0, 2.0, 10.0])
    assert float(nanmedian(x)) == 2.5
    assert float(nanmedian(x[:4])) == 2.0
    assert torch.isnan(nanmedian(torch.tensor([float("nan")])))


def test_hsml_seed(golden, halo):
    p, tree = halo
    np.testing.assert_allclose(tfr.cell_count_hsml_seed(tree, 30).numpy(),
                               golden["hsml_seed"], rtol=1e-6)


def test_hsml_init_counts_exact(golden, halo):
    """Ten controller passes and a last count: counts exactly JAX's,
    smoothing lengths to rtol 1e-6. A count may flip only where a pair
    sits at r = h within the ULP the lengths differ by: counted, none
    expected on this halo."""
    p, tree = halo
    q = tfr.tree_hsml_init_fused(p, tree, 30)
    flips = int(np.sum(q.ngb_vd.numpy() != golden["hsml_cnt"]))
    print(f"hsml init: {flips} count flips")
    assert flips == 0
    np.testing.assert_allclose(q.hsml_vd.numpy(), golden["hsml_h"],
                               rtol=1e-6)


def test_prep_gate_matches_jax(golden, halo):
    """The P_max pre-gate on the golden smoothing lengths: the scan set
    and the gated radii exactly, P_max to rtol 1e-6."""
    p, tree = halo
    sc = SIDM_SCATTER
    p = dataclasses.replace(
        p, hsml_vd=torch.tensor(golden["hsml_h"]),
        dvel=torch.tensor(sidm_pending(LIST_N)))
    params = SidmParams(sc["sigma"], 0, 1.0, 1.0, 0.0, 30, 2, False, 0.1,
                        0.0, 0.0)
    vmax = torch.sqrt(torch.max(torch.sum(p.vel ** 2, -1)))
    key = rng.step_key(rng.run_key(*SIDM_SEED), sc["step"])
    out = tree_sidm_prep(p, p.pos, tree.perm, torch.tensor(sc["time"]),
                         p.valid, vmax, key, params)
    hs, scan, h_eff, p_max = out[1], out[5], out[6], out[7]
    np.testing.assert_array_equal(scan.numpy(), golden["prep_scan"])
    np.testing.assert_array_equal(hs.numpy(), golden["prep_hs"])
    np.testing.assert_array_equal(h_eff.numpy(), golden["prep_h_eff"])
    np.testing.assert_allclose(p_max.numpy(), golden["prep_p_max"],
                               rtol=1e-6)
    np.testing.assert_array_equal(h_eff.numpy(), golden["h_eff_all"])


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """This file's part of the committed golden file is what the JAX
    package gives now."""
    live = jax_sidm_ops()
    for k, v in live.items():
        if k.startswith(KEYS):
            np.testing.assert_array_equal(v, golden[k], err_msg=k)
