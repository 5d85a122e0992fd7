"""The cached interaction lists in a periodic TreePM box (ROADMAP A, item
11.1) against the JAX package's, on the CPU.

JAX's outputs are frozen in tests/data/torch_cosmo_sidm_golden.npz
(``rl{g,r}_``; tests/make_torch_golden.py ``csidm_list_inputs``:
cosmo-sidm's clustered field at N = 1024 in its 50000 kpc/h box, the
TreePM split of a mesh of 32). Held:

* ``record_lists(pbc=)`` (geometric opening at skin 0; the relative
  criterion at a skin of 300 kpc/h): per group the far nodes (flat ids)
  and the near segment keys equal to JAX's as sets, the counts, windows and
  the overflow and demand telemetry equal (JAX's level cap, 3072, set);
* ``eval_lists(pbc=)`` on the recording tree and on its moments refreshed
  at drifted positions wrapped onto the box (particles crossing faces, so
  groups straddle them): acc within 2e-4 and the potential within 1e-4 of
  JAX's largest magnitude, tests/test_torch_pm.py's bars for the periodic
  walk (the screened pairs' erfc and exp in torch and in XLA, summed in
  another order);
* port only: at skin 0 the periodic lists evaluate to the periodic walk's
  force on the same tree (the same pair partition), within 1e-5 of the
  largest acceleration;
* ``far_level_plain``'s periodic record mode on the random node rows of
  tests/data/torch_periodic_golden.npz against JAX's ``_classify(pbc)``
  planes there: the appended flat far ids and segment keys are the planes'
  slots in frontier order, and the opened and overfull counts equal.
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.ops.far_kernel import C_BIG, C_OPEN, far_level, list_buf
from sidm_tpu_torch.ops.fused_force import (IMAX, R_CNT, R_NSTART,
                                            default_depth)
from sidm_tpu_torch.ops.list_force import (ListConfig, eval_lists,
                                           record_lists)
from sidm_tpu_torch.ops.tree import build_octree, refresh_octree
from sidm_tpu_torch.ops.wq_force import wq_gravity_tree
from sidm_tpu_torch.flagship import COSMO_BOX
from tests.make_torch_golden import (COSMO_SIDM_GOLDEN, CSIDM,
                                     PERIODIC_GOLDEN, TILE, csidm_list_inputs,
                                     tile_inputs)

torch.set_num_threads(2)

RECORDS = {"g": (False, 0.0), "r": (True, CSIDM["skin"])}
LCFG = ListConfig(lvl_cap=3072)        # JAX's default level cap


@pytest.fixture(scope="module")
def golden():
    with np.load(COSMO_SIDM_GOLDEN) as z:
        return {k: z[k] for k in z.files if k.startswith("rl")}


@pytest.fixture(scope="module")
def box(golden):
    pos, mass, eps, old, pos2 = (torch.tensor(a)
                                 for a in csidm_list_inputs())
    pbc = tuple(float(v) for v in golden["rl_pbc"])
    valid = mass > 0
    tree = build_octree(pos, mass, eps, valid, box=COSMO_BOX,
                        depth=default_depth(pos.shape[0]))
    tree2 = refresh_octree(tree, pos2, mass, eps, valid, box=COSMO_BOX)
    return dict(mass=mass, eps=eps, old=old, pbc=pbc, trees=(tree, tree2))


@pytest.fixture(scope="module")
def lists(box):
    tree = box["trees"][0]
    return {tag: record_lists(tree, box["old"][tree.perm],
                              (box["mass"] > 0)[tree.perm], theta=0.5,
                              use_relative=rel, err_tol_force_acc=0.005,
                              lcfg=LCFG, skin=skin, pbc=box["pbc"])
            for tag, (rel, skin) in RECORDS.items()}


def group_sets(keys, n):
    return [sorted(row[:c].tolist()) for row, c in zip(keys, n)]


@pytest.mark.parametrize("tag", list(RECORDS))
def test_record_lists_periodic_matches_jax(golden, lists, tag):
    got, g = lists[tag], {k[4:]: v for k, v in golden.items()
                          if k.startswith(f"rl{tag}_")}
    for f in ("nf", "nn", "pidx", "gvalid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), g[f], f)
    assert got.ovf.tolist() == g["ovf"][:4].tolist()
    assert got.need.tolist() == g["need"][:3].tolist()
    assert int(got.nf.sum()) > 0 and int(got.nn.sum()) > 0
    src = got.src.long().numpy()
    far = np.where(got.far.numpy() < len(src), src[np.minimum(
        got.far.numpy(), len(src) - 1)], -1)
    far_j = g["src"][np.minimum(g["far"], len(g["src"]) - 1)]
    assert group_sets(far, g["nf"]) == group_sets(far_j, g["nf"])
    assert group_sets(got.near.numpy(), g["nn"]) == group_sets(g["near"],
                                                               g["nn"])


def close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= tol, err


@pytest.mark.parametrize("tag", list(RECORDS))
@pytest.mark.parametrize("k", [1, 2])
def test_eval_lists_periodic_matches_jax(golden, box, lists, tag, k):
    acc, pot = eval_lists(box["trees"][k - 1], lists[tag], box["mass"],
                          box["eps"], need_pot=True, pbc=box["pbc"])
    assert bool(torch.isfinite(acc).all())
    close(acc.numpy(), golden[f"rl{tag}{k}_acc"], 2e-4)
    close(pot.numpy(), golden[f"rl{tag}{k}_pot"], 1e-4)


def test_periodic_lists_at_skin_0_are_the_walk(box, lists):
    tree = box["trees"][0]
    acc_l, _ = eval_lists(tree, lists["g"], box["mass"], box["eps"],
                          need_pot=False, pbc=box["pbc"])
    acc_w, _ = wq_gravity_tree(tree, box["mass"], box["eps"], box["old"],
                               theta=0.5, opening=0, need_pot=False,
                               pbc=box["pbc"])
    close(acc_l.numpy(), acc_w.numpy(), 1e-5)


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("rel", [False, True])
def test_far_level_record_periodic_matches_jax_classification(last, rel):
    t = tile_inputs()
    with np.load(PERIODIC_GOLDEN) as z:
        planes = {f: z[f"cl{int(last)}{int(rel)}_{f}"]
                  for f in ("far", "seg", "opn", "big")}
    B, WC = t["rows"].shape[:2]
    lvl_base = 1000
    tbl = torch.tensor(t["rows"].reshape(B * WC, 16))
    fids = torch.arange(B * WC, dtype=torch.int32).reshape(B, WC)
    buf = list_buf(B, 2 * WC, 4 * WC, "cpu")
    out = far_level(
        fids=fids, n_live=torch.full((B,), WC, dtype=torch.int32), tbl=tbl,
        nl_real=B * WC, s_l=torch.tensor(t["s_l"]),
        glo=torch.tensor(t["glo"]), ghi=torch.tensor(t["ghi"]),
        oac=torch.tensor(t["oac"]), theta2=0.25, use_relative=rel,
        leaf_cap=16, last=last, Wn=0 if last else 8 * WC, open_cap=WC,
        big_cap=64, big_chunks=4, lists=buf, lvl_base=lvl_base,
        pbc=(TILE["box"], TILE["alpha"], TILE["rcut"]))
    rows = t["rows"]
    for b in range(B):
        far = np.nonzero(planes["far"][b])[0]
        assert buf.far[b, :int(buf.nf[b])].tolist() == (
            lvl_base + b * WC + far).tolist(), b
        seg = np.nonzero(planes["seg"][b])[0]
        keys = (rows[b, seg, R_NSTART].astype(np.int64) * 32
                + np.minimum(rows[b, seg, R_CNT].astype(np.int64), 31))
        assert buf.near[b, :len(seg)].tolist() == keys.tolist(), b
        if last:
            assert int(out.cnt[C_BIG, b]) == int(planes["big"][b].sum())
        else:
            assert int(out.cnt[C_OPEN, b]) == int(planes["opn"][b].sum())
            assert int(buf.nn[b]) == len(seg)
    assert planes["far"][:-1].any() and planes["seg"][:-1].any()
    assert int(buf.nf[-1]) == 0 and int(buf.nn[-1]) == 0   # the dead group
    assert torch.all(buf.near[:, -1] == IMAX)
