"""The port's SIDM candidate lists and gated DSMC pass
(``sidm_tpu_torch.ops.list_range``) and their kernels (the range walk
``fused_range.range_segments``, ``sidm_emit``, ``sidm_gated``) vs the JAX
package (``sidm_tpu/ops/list_range.py``).

The JAX side is frozen in tests/data/torch_sidm_golden.npz
(tests/make_torch_golden.py ``sidm``): the n = 2500 NFW halo with the JAX
hsml init's smoothing lengths, which the port takes over so that both
packages search the same radii. Held exactly: ``record_candidates`` at
skin 0 and 0.5 and under tiny caps (the lists as ordered sequences, which
decides what a truncated list keeps; ncand, ovf, need, r_ref); the gated
pass's neighbour counts, partners and capacity drops, in two tiers and
under tiny capacities; the scatter pass's proposals, accepted set, scatter
count, neighbour counts and drops. Floats: P_tot to rtol 1e-5 (the sum is
taken in another order), the best keys to rtol 1e-6 and atol 4e-6 (a
key is log P_j plus Gumbel noise, each up to ~30 in size, where one ULP
of ``log`` is ~2e-6 and their sum may cancel to ~0), kicks to
1e-6 of the largest, smoothing lengths to rtol 1e-6. A partner may differ
only where two keys lie within a few ULPs (a near-tie): counted and
printed, none expected here. The kernels are held to their plain versions
on the card (``gpu``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from sidm_tpu_torch import rng
from sidm_tpu_torch.ops import list_range as tlr
from sidm_tpu_torch.ops.far_kernel import far_level
from sidm_tpu_torch.ops.fused_force import default_depth
from sidm_tpu_torch.ops.sidm import SidmParams
from sidm_tpu_torch.ops.sidm_tree import sidm_rows, tree_sidm_prep
from sidm_tpu_torch.ops.tree import build_octree
from sidm_tpu_torch.state import make_particles
from tests.make_torch_golden import (LIST_N, SIDM_GOLDEN, SIDM_SCATTER,
                                     SIDM_SEED, SIDM_SKINS, SIDM_TINY,
                                     SIDM_TINY_GATED, jax_sidm_ops,
                                     list_inputs, sidm_pending)

torch.set_num_threads(2)

KEYS = ("c0_", "c1_", "tiny_", "gated_", "gtiny_", "scat_")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(SIDM_GOLDEN))


@pytest.fixture(scope="module")
def setup(golden):
    pos, vel, mass, eps, _ = list_inputs()
    p = make_particles(pos, vel, mass, np.ones(LIST_N, np.int32),
                       pad_to_multiple=LIST_N)
    p = dataclasses.replace(p, hsml_vd=torch.tensor(golden["hsml_h"]),
                            ngb_vd=torch.tensor(golden["hsml_cnt"]))
    tree = build_octree(p.pos, p.mass, torch.tensor(eps), p.valid,
                        depth=default_depth(LIST_N))
    sc = SIDM_SCATTER
    params = SidmParams(sc["sigma"], 0, 1.0, 1.0, 0.0, 30, 2, False, 0.1,
                        0.0, 0.0)
    return dict(p=p, tree=tree, params=params,
                rcfg=tlr.RangeListConfig(k_dense=sc["k_dense"]))


def _record(setup, skin, rcfg=None, on_walk=None):
    return tlr.record_candidates_from_particles(
        setup["p"], setup["p"].pos, setup["tree"], skin=skin,
        params=setup["params"], rcfg=rcfg or setup["rcfg"],
        on_walk=on_walk)


@pytest.mark.parametrize("which", ["c0", "c1", "tiny"])
def test_record_candidates_exact(setup, golden, which):
    if which == "tiny":
        c = _record(setup, 0.0, tlr.RangeListConfig(**SIDM_TINY))
    else:
        c = _record(setup, SIDM_SKINS[int(which[1])])
        np.testing.assert_array_equal(c.r_ref.numpy(), golden[which
                                                              + "_r_ref"])
    for f in ("cand", "ncand", "ovf", "need"):
        np.testing.assert_array_equal(getattr(c, f).numpy(),
                                      golden[f"{which}_{f}"], err_msg=f)
    if which == "tiny":
        assert min(c.ovf.tolist()) > 0      # both caps overflow
    else:
        assert c.ovf.tolist() == [0, 0]


def _prep(setup, c):
    """The scatter test's pre-gate (particles with pending kicks) and the
    gated radii clamped to the lists' validity."""
    sc = SIDM_SCATTER
    p = dataclasses.replace(setup["p"],
                            dvel=torch.tensor(sidm_pending(LIST_N)))
    t = torch.tensor(sc["time"])
    vmax = torch.sqrt(torch.max(torch.sum(p.vel ** 2, -1)))
    key = rng.step_key(rng.run_key(*SIDM_SEED), sc["step"])
    tree = setup["tree"]
    rows, hs, dts, _, sigma_co, *_ = tree_sidm_prep(
        p, p.pos, tree.perm, t, p.valid, vmax, key, setup["params"])
    d = tree.pos_s - c.pos_ref
    md = torch.sqrt(torch.max(torch.sum(d * d, dim=-1)))
    hs = torch.minimum(hs, torch.clamp(c.r_ref - 2.0 * md, min=0.0))
    return p, t, vmax, key, rows, hs.contiguous(), dts, sigma_co


def _near_ties(bestk, bestj, ref_k, ref_j):
    """Partners that differ, and how many of them lie at a near-tie (the
    two packages' best keys within 4 ULPs)."""
    diff = bestj != ref_j
    gap = np.abs(np.where(np.isfinite(ref_k), bestk - ref_k, np.inf))
    tie = diff & (gap <= 4 * np.spacing(np.abs(ref_k).astype(np.float32)))
    return int(diff.sum()), int(tie.sum())


@pytest.mark.parametrize("which", ["gated", "gtiny"])
def test_eval_gated_matches_jax(setup, golden, which):
    c = _record(setup, SIDM_SKINS[1])
    p, t, _, _, rows, hs, dts, sigma_co = _prep(setup, c)
    n = LIST_N
    if which == "gated":
        ngc, ntail, kd = tlr.gated_caps(n, setup["rcfg"])
    else:
        ngc, ntail, kd = (SIDM_TINY_GATED[k] for k in ("ngc", "ntail",
                                                       "kd"))
    ptot, cnt, bestk, bestj, ovf2 = tlr.eval_gated(
        rows, c.cand, c.ncand, hs, dts, SIDM_SCATTER["salt"], t, sigma_co,
        setup["params"], ngc, ntail, kd)
    g = {f: golden[f"{which}_{f}"] for f in ("ptot", "cnt", "bestk",
                                             "bestj", "ovf2")}
    np.testing.assert_array_equal(ovf2.numpy(), g["ovf2"])
    np.testing.assert_array_equal(cnt.numpy(), g["cnt"])
    np.testing.assert_allclose(ptot.numpy(), g["ptot"], rtol=1e-5,
                               atol=1e-30)
    fin = np.isfinite(g["bestk"])
    np.testing.assert_array_equal(np.isfinite(bestk.numpy()), fin)
    np.testing.assert_allclose(bestk.numpy()[fin], g["bestk"][fin],
                               rtol=1e-6, atol=4e-6)
    diff, ties = _near_ties(bestk.numpy(), bestj.numpy(), g["bestk"],
                            g["bestj"])
    print(f"{which}: {int(fin.sum())} targets with a partner, {diff} "
          f"partners differ, {ties} of them at near-ties")
    assert diff == ties
    if which == "gated":
        # both tiers carry targets
        gate = hs.numpy() > 0
        nc = c.ncand.numpy()
        assert (gate & (nc > kd)).sum() > 10 and (gate & (nc <= kd)).sum() > 10
    else:
        assert min(ovf2.tolist()) > 0        # both capacities drop targets


def test_scatter_lists_matches_jax(setup, golden):
    """One DSMC pass: 243 proposals, conflicts resolved in several rounds;
    accepted set, proposals and counts exact, kicks to 1e-6."""
    c = _record(setup, SIDM_SKINS[1])
    p, t, vmax, key, *_ = _prep(setup, c)
    q, n_scat, viol, ovf, info = tlr.sidm_scatter_lists(
        p, p.pos, setup["tree"], c, t, p.valid, vmax, key, setup["params"],
        rcfg=setup["rcfg"], salt=SIDM_SCATTER["salt"])
    np.testing.assert_array_equal(info["proposal"].numpy(),
                                  golden["scat_proposal"])
    np.testing.assert_array_equal(info["accepted"].numpy(),
                                  golden["scat_accepted"])
    assert n_scat == int(golden["scat_n"])
    assert int((golden["scat_proposal"] >= 0).sum()) > n_scat > 0
    assert info["rounds"] > 1
    np.testing.assert_array_equal(ovf.numpy(), golden["scat_ovf"])
    np.testing.assert_array_equal(q.ngb_vd.numpy(), golden["scat_ngb_vd"])
    np.testing.assert_allclose(q.hsml_vd.numpy(), golden["scat_hsml_vd"],
                               rtol=1e-6)
    ref = golden["scat_dvel"]
    err = np.abs(q.dvel.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-6, err
    np.testing.assert_allclose(float(viol), float(golden["scat_viol"]),
                               rtol=1e-6)
    # the kicks conserve momentum pair by pair
    m = p.mass[:, None].double()
    kick = info["kick"].double()
    assert float(torch.linalg.norm(torch.sum(m * kick, 0))) <= 1e-5 * float(
        torch.sum(m * torch.linalg.norm(kick, dim=1, keepdim=True)))


def test_count_mode_is_brute_force(setup):
    """The emission's count mode on a record's segments at pad = h equals
    a brute-force count of same-type, non-pending particles with
    sqrt(r^2) < h (every particle within h lies in a recorded segment)."""
    from sidm_tpu_torch.ops.fused_force import make_windows
    from sidm_tpu_torch.ops.fused_range import (group_targets,
                                                range_levels,
                                                range_segments)
    p, tree = setup["p"], setup["tree"]
    n = LIST_N
    h = p.hsml_vd[tree.perm]
    typ = torch.ones(n, dtype=torch.int32)
    pidx, gvalid = make_windows(tree.keys_s, p.valid[tree.perm], n,
                                tree.depth)
    gt, gh, gty, gidx, glo, ghi, pad = group_targets(tree, pidx, gvalid, h,
                                                     typ)
    keys, nn, ovf, _, _ = range_segments(tree, range_levels(tree), glo, ghi,
                                         pad, seg_cap=4096)
    assert int(ovf) == 0
    aux = torch.ones(n)                      # type 1
    aux[::17] = 9.0                          # type 1, pending
    src = tlr.sidm_sources(tree.pos_s, aux)
    cnt = tlr.count_neighbours(keys, nn, src, gt, gh, gty, gidx, n)
    d = tree.pos_s[:, None, :] - tree.pos_s[None, :, :]
    r = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                   + d[..., 2] * d[..., 2])
    ok = (r < h[:, None]) & (aux < 8)[None, :] & ~torch.eye(n, dtype=bool)
    assert torch.equal(cnt, torch.sum(ok, dim=1).to(torch.int32))


# --------------------------------------------------------------- the card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _to(x, dev):
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def _tree_to(tree, dev):
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name).to(dev)
        for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), torch.Tensor)})


@pytest.mark.gpu
def test_range_walk_kernel_matches_plain_on_card(setup, cuda):
    """K1: the record's whole range walk under tiny caps (drops on
    several paths) in one launch, bit-equal to the plain walk on the same
    inputs: keys, counts, ovf, need, telemetry and the drops."""
    from sidm_tpu_torch.ops.fused_range import (range_levels,
                                                range_segments,
                                                range_walk_plain)
    walks = []
    _record(setup, SIDM_SKINS[1], tlr.RangeListConfig(**SIDM_TINY),
            on_walk=walks.append)
    kw = {k: _to(v, cuda) for k, v in walks[0].items()}
    kw["tree"] = _tree_to(kw["tree"], cuda)
    kw["rlev"] = range_levels(kw["tree"])
    drops = [{}, {}]
    n0 = far_level.range_launches
    k = range_segments(**kw, drops=drops[0])
    assert far_level.range_launches == n0 + 1
    p = range_walk_plain(**kw, drops=drops[1])
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert {x: int(v) for x, v in drops[0].items()} == \
        {x: int(v) for x, v in drops[1].items()}
    assert int(p[2]) > 0


@pytest.mark.gpu
def test_emit_and_gated_kernels_match_plain_on_card(setup, cuda):
    """K2 (emission at K = 384 and K = 16, and the count mode) bit-equal
    to the plain version; K3: counts equal, P_tot to rtol 1e-5, partners
    equal except at near-ties."""
    from sidm_tpu_torch.ops.fused_force import make_windows
    from sidm_tpu_torch.ops.fused_range import (group_targets,
                                                range_levels,
                                                range_segments)
    tree = setup["tree"]
    c = _record(setup, SIDM_SKINS[1])
    n = LIST_N
    rows = sidm_rows(setup["p"], setup["p"].pos, tree.perm)
    r_all = c.r_ref
    pidx, gvalid = make_windows(tree.keys_s, setup["p"].valid[tree.perm], n,
                                tree.depth)
    typ = torch.ones(n, dtype=torch.int32)
    gt, gr, gty, gidx, glo, ghi, pad = group_targets(tree, pidx, gvalid,
                                                     r_all, typ)
    keys, nn, _, _, _ = range_segments(tree, range_levels(tree), glo, ghi,
                                       pad, seg_cap=4096)
    src = tlr.sidm_sources(rows[:, :3], rows[:, 7])
    args = [_to(x, cuda) for x in (keys, nn, src, gt, gr, gty, gidx)]
    for K in (384, 16):
        ref = tlr.sidm_emit_plain(*args, n, K)
        got = tlr.sidm_emit(*args, n, K)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    ref = tlr.sidm_emit_plain(*args, n, 0, count_mode=True)
    assert torch.equal(tlr.count_neighbours(*args, n), ref)
    p, t, _, _, rows, hs, dts, sigma_co = _prep(setup, c)
    tid, _ = tlr.gated_targets(hs, c.ncand, c.cand.shape[1],
                               *tlr.gated_caps(n, setup["rcfg"]))
    gargs = [_to(x, cuda) for x in (rows, c.cand, c.ncand, hs, dts, tid)]
    k = tlr.sidm_gated(*gargs, 5, t.to(cuda), sigma_co.to(cuda),
                       setup["params"])
    pl = tlr.sidm_gated_plain(*gargs, 5, t.to(cuda), sigma_co.to(cuda),
                              setup["params"])
    assert torch.equal(k[1], pl[1])
    torch.testing.assert_close(k[0], pl[0], rtol=1e-5, atol=1e-30)
    diff, ties = _near_ties(*(x.cpu().numpy() for x in (k[2], k[3], pl[2],
                                                        pl[3])))
    assert diff == ties, (diff, ties)
    assert int(torch.sum(k[3] >= 0)) > 10


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """This file's part of the committed golden file is what the JAX
    package gives now."""
    live = jax_sidm_ops()
    for k, v in live.items():
        if k.startswith(KEYS):
            np.testing.assert_array_equal(v, golden[k], err_msg=k)
