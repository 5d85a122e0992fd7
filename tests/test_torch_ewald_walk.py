"""The per-pair Ewald walk of ``PMGrid -1`` in the port (``wq_gravity(
ewald=)``: the wq walk's periodic classification with no cut and the far
and near passes' Ewald modes), on the CPU, against the JAX package's
``treeforce`` outputs frozen in tests/data/torch_ewald_walk_golden.npz
(tests/make_torch_golden.py ``ewald_walk``):

* the plain Ewald modes of the far and near passes (``far_list_plain`` and
  ``near_level_plain`` with ``ewald``) on the same (group, node) pairs and
  segments as JAX's ``eval_flat`` with its ``EwaldTable`` (a JAX tree of
  EWALD["open_n"] particles of the clustered box, its moments carried
  across): within 1e-5 of JAX's largest magnitude, with and without the
  potential; the far potential with the port's isotropic second-order term
  of each node's correction (``fused_force.ewald_trace_pot`` times its raw
  quadrupole trace, ROADMAP.md C.21) added to JAX's;
* the walk against JAX's ``direct_gravity(ewald=)`` on
  tests/test_periodic_comoving.py:27-53's input (N = 2048, geometric
  opening theta 0.4): that test's bars, the rms-normalised p99 < 3e-2 and
  the potential energy within 1 %;
* at the all-open opening (the relative criterion with ErrTolForceAcc 0,
  hence the geometric test at theta 1e-6: no cell is accepted as a far
  node by either walk, none dropped) on EWALD["open_n"] particles of that
  box: the port's walk, JAX's ``tree_gravity(ewald=)`` and JAX's direct
  sum agree within 1e-5 of the largest |a| (and of the largest |pot|);
* the node-level correction's potential bias (ROADMAP.md C.21): on a
  clustered cosmo box (``cosmo_ics``, N = 2048) at geometric theta 0.4
  JAX's ``tree_gravity(ewald=)`` misses the Ewald direct sum's potential
  energy by more than 1e-3, the port's walk, which adds the isotropic
  term of each far node's correction, by less than 1e-4; the forces of
  both stay within tests/test_periodic_comoving.py's bar;
* the interleaved table (``EwaldTable.table4``) holds the four tables,
  and ``EwaldTable.lookup`` gives ``trilerp``'s values bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sidm_tpu_torch.ops import fused_force as tff
from sidm_tpu_torch.ops.ewald import build_ewald_table, interleaved, trilerp
from sidm_tpu_torch.ops.far_list import far_list_plain
from sidm_tpu_torch.ops.near_kernel import near_level_plain
from sidm_tpu_torch.ops.tree import build_octree
from sidm_tpu_torch.ops.wq_force import wq_gravity
from sidm_tpu_torch.flagship import COSMO_BOX, cosmo_ics, cosmo_softening
from tests.make_torch_golden import (EWALD, EWALD_COSMO, EWALD_WALK_GOLDEN,
                                     ewald_inputs)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    with np.load(EWALD_WALK_GOLDEN) as z:
        return {k: z[k] for k in z.files if not k.startswith("r")}


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    return build_ewald_table(EWALD["box"],
                             cache_dir=str(tmp_path_factory.mktemp("ew")))


def close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), \
        np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def tiles(golden):
    """The port's tree of the tiles' particles with JAX's moments, its
    target groups, and the pairs and segments as its kernels' inputs."""
    pos, mass, eps = (torch.tensor(a) for a in ewald_inputs(EWALD["open_n"]))
    n = len(mass)
    tree = build_octree(pos, mass, eps, torch.ones(n, dtype=torch.bool),
                        box=EWALD["box"], depth=8)
    jm = torch.tensor(golden["t_mac_rows"])
    assert torch.equal(tree.mac_rows[:, 4:8], jm[:, 4:8])
    tree = dataclasses.replace(tree, mac_rows=jm, quad_rows=torch.tensor(
        golden["t_quad_rows"]))
    ng = n // 64
    xr = tree.pos_s.reshape(ng, 64, 3).contiguous()
    te = tree.eps_s.reshape(ng, 64).contiguous()
    ftree = tff.pack_tree(tree)
    tbl = tff.flat_tables(ftree)
    trq = torch.cat(list(ftree.levels_tr))
    pg, pn = golden["t_pair_g"], golden["t_pair_n"]
    per = len(pg) // ng
    ids = torch.tensor(pn.reshape(ng, per))
    sg, ss, sc = golden["t_seg_g"], golden["t_seg_s"], golden["t_seg_c"]
    keys = torch.tensor((ss * 32 + sc).reshape(ng, -1).astype(np.int32))
    return dict(tree=tree, xr=xr, te=te, tbl=tbl, trq=trq, ids=ids,
                nf=torch.full((ng,), per, dtype=torch.int32), keys=keys,
                nn=torch.full((ng,), keys.shape[1], dtype=torch.int32))


@pytest.mark.parametrize("need_pot", [False, True])
def test_ewald_far_mode_matches_eval_flat(golden, tiles, table, need_pot):
    s = tiles
    a = far_list_plain(s["tbl"], s["ids"], s["nf"], s["xr"], s["te"],
                       torch.zeros(len(s["nf"]), 3), need_pot=need_pot,
                       trq=s["trq"], ewald=table)
    close(a[..., :3], golden["tf_acc"], 1e-5)
    if need_pot:
        trace = tff.ewald_trace_pot(EWALD["box"]) * s["trq"][
            s["ids"].long()].double().sum(1)
        assert float(trace.abs().max()) > 0
        close(a[..., 3], golden["tf_pot"] + trace[:, None].numpy(), 1e-5)
    else:
        assert not a[..., 3].any()


@pytest.mark.parametrize("need_pot", [False, True])
def test_ewald_near_mode_matches_eval_flat(golden, tiles, table, need_pot):
    s, t = tiles, tiles["tree"]
    a = near_level_plain(s["keys"], s["nn"], t.pos_s, t.mass_s, t.eps_s,
                         s["xr"], s["te"], need_pot=need_pot, ewald=table)
    close(a[..., :3], golden["tn_acc"], 1e-5)
    if need_pot:
        close(a[..., 3], golden["tn_pot"], 1e-5)


def test_ewald_walk_matches_direct(golden, table):
    """tests/test_periodic_comoving.py:27-53 with the port's walk."""
    pos, mass, eps = (torch.tensor(a) for a in ewald_inputs())
    acc, pot, info = wq_gravity(pos, mass, eps, torch.zeros(len(mass)),
                                theta=EWALD["theta"], opening=0, ewald=table,
                                return_info=True)
    assert sum(int(info[f]) for f in ("ovf_open", "ovf_big",
                                      "ovf_items")) == 0
    ad = golden["w_dacc"].astype(np.float64)
    rms = np.sqrt((ad ** 2).sum(1)).mean()
    for a in (acc.double().numpy(), golden["w_acc"]):
        err = np.linalg.norm(a - ad, axis=1) / rms
        assert np.percentile(err, 99) < 3e-2
    m = mass.double().numpy()
    pe_d = 0.5 * (m * golden["w_dpot"]).sum()
    for p in (pot.double().numpy(), golden["w_pot"]):
        assert abs(0.5 * (m * p).sum() - pe_d) < 0.01 * abs(pe_d)


def test_all_open_walks_agree(golden, table):
    """At the all-open opening neither walk accepts a far node: both are
    the Ewald direct sum, to float32 rounding."""
    pos, mass, eps = (torch.tensor(a) for a in ewald_inputs(EWALD["open_n"]))
    nf = []

    def spy(name, level, kw):
        if name == "far_list":
            nf.append(int(kw["nf"].sum()))
    from sidm_tpu_torch.ops.wq_force import wq_gravity_tree
    tree = build_octree(pos, mass, eps, mass > 0, box=EWALD["box"],
                        depth=tff.default_depth(len(mass)))
    acc, pot, info = wq_gravity_tree(
        tree, mass, eps, torch.ones(len(mass)), theta=EWALD["theta_open"],
        opening=1, err_tol_force_acc=0.0, return_info=True, ewald=table,
        on_level=spy)
    assert nf and sum(nf) == 0
    assert sum(int(info[f]) for f in ("ovf_open", "ovf_big",
                                      "ovf_items")) == 0
    assert int(golden["o_n_pairs"]) == 0 and int(golden["o_dropped"]) == 0
    ad, pd = golden["o_dacc"], golden["o_dpot"]
    top_a = np.linalg.norm(ad, axis=1).max()
    for a, p in ((acc.numpy(), pot.numpy()),
                 (golden["o_acc"], golden["o_pot"])):
        assert np.abs(a - ad).max() <= 1e-5 * top_a
        assert np.abs(p - pd).max() <= 1e-5 * np.abs(pd).max()
    assert np.abs(acc.numpy() - golden["o_acc"]).max() <= 1e-5 * top_a


def test_node_correction_trace_term(golden, tmp_path):
    ec = EWALD_COSMO
    pos, _, mass = cosmo_ics(ec["n"], ec["seed"])
    m = torch.tensor(mass, dtype=torch.float32)
    eps = torch.full((ec["n"],), cosmo_softening(ec["n"])[0])
    tab = build_ewald_table(COSMO_BOX, cache_dir=str(tmp_path))
    acc, pot = wq_gravity(torch.tensor(pos, dtype=torch.float32), m, eps,
                          torch.zeros(ec["n"]), theta=ec["theta"], opening=0,
                          ewald=tab)
    md = mass.astype(np.float64)
    ad = golden["c_dacc"].astype(np.float64)
    pe_d = 0.5 * (md * golden["c_dpot"]).sum()
    errs = {}
    for who, a, p in (("port", acc.double().numpy(), pot.double().numpy()),
                      ("jax", golden["c_acc"], golden["c_pot"])):
        rms = np.sqrt((ad ** 2).sum(1)).mean()
        assert np.percentile(np.linalg.norm(a - ad, axis=1) / rms, 99) < 3e-2
        errs[who] = abs(0.5 * (md * p).sum() - pe_d) / abs(pe_d)
    assert errs["jax"] > 1e-3 and errs["port"] < 1e-4, errs


def test_interleaved_table_and_lookup(table):
    t4 = interleaved(table)
    m = table.en // 2 + 1
    assert t4 is table.table4 and t4.shape == (m, m, m, 4)
    assert torch.equal(t4[..., :3], table.fcorr.permute(1, 2, 3, 0))
    assert torch.equal(t4[..., 3], table.potcorr)
    assert torch.equal(interleaved(table._replace(table4=None)), t4)
    d = torch.tensor(np.random.default_rng(2).uniform(
        -0.5, 0.5, (300, 3)).astype(np.float32)) * EWALD["box"]
    d[0] = 0.0
    i, u = table._index(d)
    f, p = table.lookup(d)
    s = torch.sign(d)
    want = -torch.stack([s[:, c] * trilerp(table.fcorr[c], i, u)
                         for c in range(3)], dim=-1)
    assert torch.equal(f, want)
    assert torch.equal(p, trilerp(table.potcorr, i, u))
    assert torch.equal(table.force_correction(d), want)
    assert not f[0].any() and float(p[0]) == pytest.approx(
        2.8372975 / EWALD["box"], rel=1e-6)


@pytest.mark.slow
def test_golden_is_current_jax_output():
    """The committed golden file is what the JAX package gives now (its
    steps' outputs included)."""
    from tests.make_torch_golden import jax_ewald_walk
    live = jax_ewald_walk()
    with np.load(EWALD_WALK_GOLDEN) as z:
        assert sorted(live) == sorted(z.files)
        for k, v in live.items():
            np.testing.assert_array_equal(v, z[k], err_msg=k)
