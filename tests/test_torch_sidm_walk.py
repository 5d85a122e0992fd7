"""The port's DSMC engine on the range walk (``sidm_tpu_torch.ops.
fused_range``: ``sidm_near`` and its kernel ``csrc/sidm_near.cu``,
``sidm_scatter_fused``) and the periodic minimum image on the DSMC path
(``build_octree(box=)``, the range walk, the emission, the gated tile,
``tree_hsml_init_fused(box=)``) vs the JAX package
(``sidm_tpu/ops/fused_range.py``, ``list_range.py``).

The JAX side is frozen in tests/data/torch_sidm_walk_golden.npz
(tests/make_torch_golden.py ``sidm_walk``); the ``slow`` test reruns it and
holds the file to it.

* ``sidm_near_plain`` against JAX's ``_sidm_near_tile`` as
  ``_sidm_near_level`` runs it, on the same random segment lists (hard
  sphere; Yukawa in a periodic box): counts exact, P_tot to rtol 1e-5 (the
  sum is taken in another order), best keys to rtol 1e-6 and atol 4e-6
  (``log`` may round one ULP apart; see tests/test_torch_sidm_lists.py),
  partners equal except at near-ties (keys within 4 ULPs; JAX's winner on
  an exact tie depends on its chunking, the port's is the larger sorted
  id). The inputs give each target ~20–80 pairs, as the walk's targets
  have (tests/make_torch_golden.py ``near_inputs``): a sum of a single
  pair at r ~ h carries one float32 ULP of r, which XLA and PyTorch may
  round apart, amplified by 1/(1 - r/h) in W.
* ``sidm_scatter_fused`` against JAX's at N = 2048, without a box (the
  uniform box of tests/test_fused_range.py::test_fused_matches_segment_
  engine, JAX's smoothing lengths taken over) and with one (a cluster
  across the box corner, as test_periodic_hsml_counts_exact_min_image
  builds it): neighbour counts exact, smoothing lengths to rtol 1e-6, the
  kicks to rtol 1e-5 / atol 1e-7 where both scatter, and at most max(2, 2 %
  of the scatters) particles that scatter in one package only (a
  rand-vs-P_tot decision flipped by the sum's rounding), as that JAX test
  allows.
* With the box: the tree's order exactly, ``tree_hsml_init_fused`` (counts
  exact, lengths rtol 1e-6), ``record_candidates_from_particles`` (the
  plain range walk and the emission: lists, counts, caps' telemetry
  exactly) and the gated tile (as in test_torch_sidm_lists.py).
* On the card (``gpu``): the segment pass kernel against
  ``sidm_near_plain`` with and without the box, and the range walk, the
  emission and the gated tile against their plain versions with the box.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sidm_tpu_torch import rng
from sidm_tpu_torch.ops import fused_range as tfr
from sidm_tpu_torch.ops import list_range as tlr
from sidm_tpu_torch.ops.sidm import SidmParams
from sidm_tpu_torch.ops.sidm_tree import tree_sidm_prep
from sidm_tpu_torch.ops.tree import build_octree
from sidm_tpu_torch.state import make_particles
from tests.make_torch_golden import (NEAR, SIDM_SEED, SIDM_WALK_GOLDEN,
                                     WALK_A, WALK_B, jax_sidm_walk_ops,
                                     near_inputs, near_params, sidm_pending,
                                     walk_a_inputs, walk_b_inputs)

torch.set_num_threads(2)

KEYS = ("n0_", "n2_", "a_", "b_")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(SIDM_WALK_GOLDEN))


def _near_ties(bestk, bestj, ref_k, ref_j):
    """Partners that differ, and how many of them lie at a near-tie (the
    two best keys within 4 ULPs)."""
    diff = bestj != ref_j
    fin = np.isfinite(ref_k)
    gap = np.full(ref_k.shape, np.inf, np.float32)
    gap[fin] = np.abs(bestk[fin] - ref_k[fin])
    tie = diff & (gap <= 4 * np.spacing(np.abs(ref_k).astype(np.float32)))
    return int(diff.sum()), int(tie.sum())


def _near_args(name):
    """``sidm_near``'s tensor arguments (keys, nn, rows, gt, gv, gh, gdt,
    gty, gidx), the parameters, sigma_co and the box of one check."""
    box = NEAR["box"] if name == "n2" else 0.0
    fields, sco = near_params(0 if name == "n0" else 2)
    rows, keys, nn, *slots = (torch.tensor(x) for x in near_inputs(box))
    return [keys, nn, rows, *slots], SidmParams(**fields), \
        torch.tensor(sco), box


@pytest.mark.parametrize("name", ["n0", "n2"])
def test_near_plain_matches_jax(golden, name):
    ins, params, sco, box = _near_args(name)
    ptot, ncnt, bestk, bestj = tfr.sidm_near(
        *ins, NEAR["salt"], torch.tensor(NEAR["time"]), sco, params, box)
    g = {f: golden[f"{name}_{f}"] for f in ("ptot", "ncnt", "bestk",
                                            "bestj")}
    np.testing.assert_array_equal(ncnt.numpy(), g["ncnt"])
    np.testing.assert_allclose(ptot.numpy(), g["ptot"], rtol=1e-5,
                               atol=1e-30)
    fin = np.isfinite(g["bestk"])
    np.testing.assert_array_equal(np.isfinite(bestk.numpy()), fin)
    np.testing.assert_allclose(bestk.numpy()[fin], g["bestk"][fin],
                               rtol=1e-6, atol=4e-6)
    diff, ties = _near_ties(bestk.numpy(), bestj.numpy(), g["bestk"],
                            g["bestj"])
    print(f"{name}: {int(fin.sum())} slots with a partner, {int(ncnt.sum())}"
          f" pairs, {diff} partners differ, {ties} of them at near-ties")
    assert diff == ties and fin.sum() > 300


def _walk_setup(which, golden):
    """(particles, tree, params, time, vmax, key, salt, box) of WALK_A or
    WALK_B, with JAX's smoothing lengths (and WALK_B's pending kicks)."""
    if which == "a":
        c, (pos, vel, mass) = WALK_A, walk_a_inputs()
        box, h = 0.0, golden["a_hsml"]
        key = rng.run_key(5, 5)
    else:
        c, (pos, vel, mass) = WALK_B, walk_b_inputs()
        box, h = c["box"], golden["b_hsml"]
        key = rng.step_key(rng.run_key(*SIDM_SEED), c["step"])
    n = c["n"]
    p = make_particles(pos, vel, mass, np.ones(n, np.int32),
                       pad_to_multiple=n)
    p = dataclasses.replace(p, hsml_vd=torch.tensor(h))
    if which == "b":
        p = dataclasses.replace(p, ngb_vd=torch.tensor(golden["b_ngb"]),
                                dvel=torch.tensor(sidm_pending(n)))
        tree = build_octree(p.pos, p.mass, torch.full((n,), 0.1), p.valid,
                            box=box, depth=c["depth"])
    else:
        tree = build_octree(p.pos, p.mass, torch.full((n,), 0.01), p.valid)
    params = SidmParams(c["sigma"], 0, 1.0, 1.0, 0.0, 30, 2, False, 0.1,
                        0.0, 0.0, maintenance_rate=1.0)
    return (p, tree, params, torch.tensor(c["time"]),
            torch.tensor(c["vmax"]), key, c["salt"], box)


@pytest.mark.parametrize("which", ["a", "b"])
def test_scatter_fused_matches_jax(golden, which):
    p, tree, params, t, vmax, key, salt, box = _walk_setup(which, golden)
    q, ns, info = tfr.sidm_scatter_fused(p, p.pos, tree, t, p.valid, vmax,
                                         key, params, salt=salt, box=box,
                                         return_info=True)
    g = {f: golden[f"{which}_{f}"] for f in ("n_scat", "dvel", "hsml_vd",
                                             "ngb_vd", "ovf")}
    drops = [int(info[k]) for k in ("ovf_walk", "ovf_big", "ovf_seg")]
    assert drops == [0, 0, 0] and g["ovf"].tolist() == [0, 0]
    np.testing.assert_array_equal(q.ngb_vd.numpy(), g["ngb_vd"])
    np.testing.assert_allclose(q.hsml_vd.numpy(), g["hsml_vd"], rtol=1e-6)
    d0 = p.dvel.numpy()
    mine, ref = q.dvel.numpy() - d0, g["dvel"] - d0
    sm, sr = np.any(mine != 0, axis=1), np.any(ref != 0, axis=1)
    both = sm & sr
    np.testing.assert_allclose(mine[both], ref[both], rtol=1e-5, atol=1e-7)
    flips = int(np.sum(sm != sr))
    print(f"{which}: {int(ns)} scatters (JAX {int(g['n_scat'])}), "
          f"{int(both.sum())} kicked in both, {flips} in one only")
    assert flips <= max(2, int(0.02 * max(int(g["n_scat"]), 1)))
    assert int(ns) > 20


def test_walk_caps_grow_to_demand(golden):
    """A walk whose caps drop cells is walked again with larger caps: tiny
    caps (open_cap, w_max, big_cap, big_chunks) give the default caps'
    result exactly, and the caps that were used come back larger."""
    from sidm_tpu_torch.ops.fused_force import FusedConfig
    p, tree, params, t, vmax, key, salt, box = _walk_setup("a", golden)
    tiny = FusedConfig(w_max=128, open_cap=8, big_cap=1, big_chunks=1)
    outs = [tfr.sidm_scatter_fused(p, p.pos, tree, t, p.valid, vmax, key,
                                   params, cfg=cfg, salt=salt,
                                   return_info=True) for cfg in (None, tiny)]
    (q0, n0, i0), (q1, n1, i1) = outs
    assert i1["cfg"].open_cap > tiny.open_cap and i1["cfg"].w_max > 128
    for i in (i0, i1):
        assert [int(i[k]) for k in ("ovf_walk", "ovf_big", "ovf_seg")] \
            == [0, 0, 0]
    assert int(n0) == int(n1) == int(golden["a_n_scat"])
    assert torch.equal(q0.ngb_vd, q1.ngb_vd)
    assert torch.equal(q0.dvel, q1.dvel)


@pytest.fixture(scope="module")
def box_halo(golden):
    """WALK_B's periodic tree and particles before the hsml init."""
    b = WALK_B
    pos, vel, mass = walk_b_inputs()
    n = b["n"]
    p = make_particles(pos, vel, mass, np.ones(n, np.int32),
                       pad_to_multiple=n)
    tree = build_octree(p.pos, p.mass, torch.full((n,), 0.1), p.valid,
                        box=b["box"], depth=b["depth"])
    return p, tree


def test_box_tree_and_hsml_init_match_jax(golden, box_halo):
    """The tree on the box (its order exactly) and the hsml init's
    minimum-image counts (exactly) and lengths (rtol 1e-6)."""
    p, tree = box_halo
    np.testing.assert_array_equal(tree.perm.numpy(), golden["b_perm"])
    assert float(tree.extent) == WALK_B["box"]
    assert torch.equal(tree.origin, torch.zeros(3))
    q = tfr.tree_hsml_init_fused(p, tree, 30, box=WALK_B["box"])
    np.testing.assert_array_equal(q.ngb_vd.numpy(), golden["b_ngb"])
    np.testing.assert_allclose(q.hsml_vd.numpy(), golden["b_hsml"],
                               rtol=1e-6)


def _box_cands(golden, box_halo):
    b = WALK_B
    p, tree = box_halo
    p = dataclasses.replace(p, hsml_vd=torch.tensor(golden["b_hsml"]),
                            ngb_vd=torch.tensor(golden["b_ngb"]))
    params = SidmParams(b["sigma"], 0, 1.0, 1.0, 0.0, 30, 2, False, 0.1,
                        0.0, 0.0, maintenance_rate=1.0)
    rcfg = tlr.RangeListConfig(k_dense=48)
    c = tlr.record_candidates_from_particles(
        p, p.pos, tree, skin=b["skin"], params=params, box=b["box"],
        rcfg=rcfg)
    return p, tree, params, rcfg, c


def test_box_candidates_match_jax(golden, box_halo):
    """The range walk and the emission with the box: the
    candidate lists as ordered sequences, counts, radii, drops and demand
    exactly."""
    _, _, _, _, c = _box_cands(golden, box_halo)
    for f in ("cand", "ncand", "r_ref", "ovf", "need"):
        np.testing.assert_array_equal(getattr(c, f).numpy(),
                                      golden["b_c_" + f], err_msg=f)
    # the minimum image adds neighbours across the faces
    assert int(c.ncand.sum()) > 0 and c.ovf.tolist()[0] == 0


def _box_gated_args(golden, box_halo):
    b = WALK_B
    p, tree, params, rcfg, c = _box_cands(golden, box_halo)
    pp = dataclasses.replace(p, dvel=torch.tensor(sidm_pending(b["n"])))
    key = rng.step_key(rng.run_key(*SIDM_SEED), b["step"])
    t = torch.tensor(b["time"])
    rows, hs, dts, _, sigma_co, *_ = tree_sidm_prep(
        pp, pp.pos, tree.perm, t, pp.valid, torch.tensor(b["vmax"]), key,
        params)
    hs = torch.minimum(hs, c.r_ref).contiguous()
    return rows, c, hs, dts, t, sigma_co, params, rcfg


def test_box_gated_tile_matches_jax(golden, box_halo):
    rows, c, hs, dts, t, sigma_co, params, rcfg = _box_gated_args(
        golden, box_halo)
    ngc, ntail, _ = tlr.gated_caps(WALK_B["n"], rcfg)
    ptot, cnt, bestk, bestj, ovf2 = tlr.eval_gated(
        rows, c.cand, c.ncand, hs, dts, WALK_B["salt"], t, sigma_co, params,
        ngc, ntail, 48, box=WALK_B["box"])
    g = {f: golden["b_g_" + f] for f in ("ptot", "cnt", "bestk", "bestj",
                                         "ovf2")}
    np.testing.assert_array_equal(ovf2.numpy(), g["ovf2"])
    np.testing.assert_array_equal(cnt.numpy(), g["cnt"])
    np.testing.assert_allclose(ptot.numpy(), g["ptot"], rtol=1e-5,
                               atol=1e-30)
    fin = np.isfinite(g["bestk"])
    np.testing.assert_allclose(bestk.numpy()[fin], g["bestk"][fin],
                               rtol=1e-6, atol=4e-6)
    diff, ties = _near_ties(bestk.numpy(), bestj.numpy(), g["bestk"],
                            g["bestj"])
    assert diff == ties and fin.sum() > 1000


# --------------------------------------------------------------- the card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _to(x, dev):
    return x.to(dev) if isinstance(x, torch.Tensor) else x


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["n0", "n2"])
def test_near_kernel_matches_plain_on_card(cuda, name):
    """K4 against ``sidm_near_plain`` on the same inputs, without and with
    the box: counts equal, P_tot to rtol 1e-5, best keys bit-equal where
    the partners agree, partners equal except at near-ties."""
    ins, params, sco, box = _near_args(name)
    ins = [x.to(cuda).contiguous() for x in ins]
    args = (*ins, NEAR["salt"], torch.tensor(NEAR["time"], device=cuda),
            sco.to(cuda), params, box)
    n0 = tfr.sidm_near.launches
    k = tfr.sidm_near(*args)
    assert tfr.sidm_near.launches == n0 + 1
    pl = tfr.sidm_near_plain(*args)
    assert torch.equal(k[1], pl[1])
    torch.testing.assert_close(k[0], pl[0], rtol=1e-5, atol=1e-30)
    kk, kj, pk, pj = (x.cpu().numpy() for x in (k[2], k[3], pl[2], pl[3]))
    same = kj == pj
    np.testing.assert_array_equal(kk[same], pk[same])
    diff, ties = _near_ties(kk, kj, pk, pj)
    assert diff == ties, (diff, ties)


@pytest.mark.gpu
def test_box_kernels_match_plain_on_card(golden, box_halo, cuda):
    """With the box: K1 (the record's whole range walk, one launch) and
    K2 (the emission and its count mode) bit-equal to their plain
    versions; K3: counts equal, P_tot to rtol 1e-5, partners equal except
    at near-ties."""
    from sidm_tpu_torch.ops.far_kernel import far_level
    b = WALK_B
    walks, emits = [], []
    p, tree = box_halo
    p = dataclasses.replace(p, hsml_vd=torch.tensor(golden["b_hsml"]))
    params = SidmParams(b["sigma"], 0, 1.0, 1.0, 0.0, 30, 2, False, 0.1,
                        0.0, 0.0, maintenance_rate=1.0)
    tlr.record_candidates_from_particles(
        p, p.pos, tree, skin=b["skin"], params=params, box=b["box"],
        rcfg=tlr.RangeListConfig(k_dense=48),
        on_walk=walks.append, on_emit=emits.append)
    kw = {k: _to(v, cuda) for k, v in walks[0].items()}
    assert kw["box"] == b["box"]
    kw["tree"] = dataclasses.replace(kw["tree"], **{
        f.name: _to(getattr(kw["tree"], f.name), cuda)
        for f in dataclasses.fields(kw["tree"])})
    kw["rlev"] = tfr.range_levels(kw["tree"])
    drops = [{}, {}]
    n0 = far_level.range_launches
    k = tfr.range_segments(**kw, drops=drops[0])
    assert far_level.range_launches == n0 + 1
    pl = tfr.range_walk_plain(**kw, drops=drops[1])
    for x, y in zip(k, pl):
        assert torch.equal(x, y)
    assert {x: int(v) for x, v in drops[0].items()} == \
        {x: int(v) for x, v in drops[1].items()}
    kw = {k: _to(v, cuda) for k, v in emits[0].items()}
    base = [kw[k] for k in ("keys", "nn", "src", "gt", "gr", "gty", "gidx")]
    for K in (kw["K"], 16):
        got = tlr.sidm_emit(*base, kw["n"], K, box=b["box"])
        ref = tlr.sidm_emit_plain(*base, kw["n"], K, box=b["box"])
        assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert torch.equal(
        tlr.count_neighbours(*base, kw["n"], box=b["box"]),
        tlr.sidm_emit_plain(*base, kw["n"], 0, count_mode=True,
                            box=b["box"]))
    rows, c, hs, dts, t, sigma_co, params, rcfg = _box_gated_args(
        golden, box_halo)
    tid, _ = tlr.gated_targets(hs, c.ncand, c.cand.shape[1],
                               *tlr.gated_caps(b["n"], rcfg))
    gargs = [_to(x, cuda) for x in (rows, c.cand, c.ncand, hs, dts, tid)]
    rest = (b["salt"], t.to(cuda), sigma_co.to(cuda), params, b["box"])
    k = tlr.sidm_gated(*gargs, *rest)
    pl = tlr.sidm_gated_plain(*gargs, *rest)
    assert torch.equal(k[1], pl[1])
    torch.testing.assert_close(k[0], pl[0], rtol=1e-5, atol=1e-30)
    diff, ties = _near_ties(*(x.cpu().numpy() for x in (k[2], k[3], pl[2],
                                                        pl[3])))
    assert diff == ties, (diff, ties)


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """This file's part of the committed golden file is what the JAX
    package gives now."""
    live = jax_sidm_walk_ops()
    for k, v in live.items():
        if k.startswith(KEYS):
            np.testing.assert_array_equal(v, golden[k], err_msg=k)
