"""The periodic modes of the walk's kernels and of the direct sum against
their plain versions on the card (``gpu`` marker: skipped without one; on
the card ``python -m pytest tests/ -q -m gpu -k periodic``).

A small cosmo-box (``flagship.cosmo_config``, N = 16384, mesh 128) is walked
on the card with ``wq_gravity(pbc=)``; every ``far_level``, ``far_list``
and ``near_level`` call of the walk is repeated on the plain version with
the same inputs. Its cached lists are recorded with ``record_lists(pbc=)``
(the relative criterion, a skin): every level's ``far_level`` call in the
periodic record mode is repeated on the plain version from the same lists
(the appended lists, counts and telemetry equal); the lists' evaluation
(``far_list`` and ``near_level`` in their periodic modes on the compact
table, the raw targets and the traces) is held to the same calls on the
plain versions. Bars: far_level's compacted outputs and counts equal;
far_list and near_level p99.9 relative error < 2e-5 on acc and pot (the
kernels' erfcf, erff and expf differ from torch's by a few ULP and sum in
another order); the periodic direct sum p99.9 < 1e-5 on acc and pot
against max(|plain|, median |plain|) (float64 tile sums against the plain
version's chunked float32 sums; a periodic potential can be ~0).
This file does not import JAX.
"""

import pytest
import torch

from sidm_tpu_torch.flagship import cosmo_config, cosmo_ics
from sidm_tpu_torch.ops.direct import direct_gravity, direct_sum
from sidm_tpu_torch.ops.ewald import build_ewald_table
from sidm_tpu_torch.ops.far_kernel import (ListBuf, far_level,
                                           far_level_plain)
from sidm_tpu_torch.ops.far_list import far_list, far_list_plain
from sidm_tpu_torch.ops.list_force import (compact_traces, eval_inputs,
                                           record_lists)
from sidm_tpu_torch.ops.near_kernel import near_level, near_level_plain
from sidm_tpu_torch.ops.pm import build_pm_kernel
from sidm_tpu_torch.ops.fused_force import default_depth
from sidm_tpu_torch.ops.tree import build_octree
from sidm_tpu_torch.ops.wq_force import wq_gravity_tree

N = 16384
MESH = 128
IMAX = 2147483647


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def box_setup(cuda):
    cfg = cosmo_config(N, PMGrid=MESH)
    pos, _, mass = cosmo_ics(N, 5)
    kern = build_pm_kernel(cfg.BoxSize, n=MESH, asmth=cfg.PMAsmth,
                           rcut_fac=cfg.PMRcutFac, device=cuda)
    pbc = (cfg.BoxSize, kern.alpha, kern.rcut)
    t = dict(pos=torch.tensor(pos, dtype=torch.float32, device=cuda),
             mass=torch.tensor(mass, dtype=torch.float32, device=cuda),
             eps=torch.full((N,), cfg.SofteningHalo, dtype=torch.float32,
                            device=cuda))
    return cfg, pbc, t


def p999(a, b, valid):
    """p99.9 of the relative acc and pot errors of a against b (ng, 64, 4)
    over the valid targets."""
    va, vb = a[valid], b[valid]
    e = torch.linalg.norm(va[:, :3] - vb[:, :3], dim=1) / torch.clamp(
        torch.linalg.norm(vb[:, :3], dim=1), min=1e-30)
    ep = torch.abs(va[:, 3] - vb[:, 3]) / torch.clamp(torch.abs(vb[:, 3]),
                                                      min=1e-30)
    return (float(torch.quantile(e.double(), 0.999)),
            float(torch.quantile(ep.double(), 0.999)))


def walk_calls(box_setup, need_pot):
    """Every kernel call of one periodic walk: (name, level, kwargs)."""
    cfg, pbc, t = box_setup
    calls = []
    tree = build_octree(t["pos"], t["mass"], t["eps"], t["mass"] > 0,
                        box=cfg.BoxSize, depth=default_depth(N))
    wq_gravity_tree(tree, t["mass"], t["eps"],
                    torch.zeros(N, device=t["pos"].device), theta=0.5,
                    opening=0, pbc=pbc, need_pot=need_pot,
                    on_level=lambda name, level, kw: calls.append(
                        (name, level, dict(kw))))
    return calls


@pytest.mark.gpu
def test_far_level_periodic_matches_plain_on_card(box_setup):
    calls = [c for c in walk_calls(box_setup, False) if c[0] == "far_level"]
    assert calls and all(c[2]["pbc"] is not None for c in calls)
    launched = far_level.periodic_launches
    for _, level, kw in calls:
        k, p = far_level(**kw), far_level_plain(**kw)
        assert torch.equal(k.cnt, p.cnt), level
        for f, row, tail in (("far", 0, IMAX), ("seg", 1, IMAX),
                             ("fids", 2, -1), ("bkey", 6, IMAX)):
            pv = getattr(p, f)
            if pv is None:
                continue
            kv = getattr(k, f)
            live = (torch.arange(pv.shape[1], device=pv.device)[None, :]
                    < p.cnt[row][:, None])
            assert torch.equal(torch.where(live, kv, tail),
                               torch.where(live, pv, tail)), (level, f)
    assert far_level.periodic_launches == launched + len(calls)


def box_tree(box_setup):
    cfg, pbc, t = box_setup
    return build_octree(t["pos"], t["mass"], t["eps"], t["mass"] > 0,
                        box=cfg.BoxSize, depth=default_depth(N))


def box_lists(box_setup, tree, on_level=None):
    """The box's cached lists: relative criterion with a made-up |a_old|,
    a skin of 100 kpc/h."""
    _, pbc, t = box_setup
    old = torch.full((N,), 1e3, device=t["pos"].device)
    return record_lists(tree, old[tree.perm], (t["mass"] > 0)[tree.perm],
                        theta=0.5, use_relative=True, skin=100.0, pbc=pbc,
                        on_level=on_level)


@pytest.mark.gpu
def test_far_level_record_periodic_matches_plain_on_card(box_setup):
    tree = box_tree(box_setup)
    levels = []

    def check(level, kw):
        bufs = [ListBuf(*(x.clone() for x in kw["lists"])) for _ in range(2)]
        k = far_level(**dict(kw, lists=bufs[0]))
        p = far_level_plain(**dict(kw, lists=bufs[1]))
        assert torch.equal(k.cnt, p.cnt), level
        if p.fids is not None:
            live = (torch.arange(p.fids.shape[1], device=p.fids.device)
                    [None, :] < p.cnt[2][:, None])
            assert torch.equal(torch.where(live, k.fids, -1),
                               torch.where(live, p.fids, -1)), level
        a, b = bufs
        assert torch.equal(a.nf, b.nf) and torch.equal(a.nn, b.nn), level
        assert torch.equal(a.stat, b.stat) and torch.equal(a.near, b.near)
        live = (torch.arange(a.far.shape[1], device=a.far.device)[None, :]
                < a.nf[:, None])
        assert torch.equal(torch.where(live, a.far, -1),
                           torch.where(live, b.far, -1)), level
        levels.append(level)

    launched = far_level.periodic_record_launches
    lists = box_lists(box_setup, tree, on_level=check)
    assert levels and int(lists.nf.sum()) > 0 and int(lists.nn.sum()) > 0
    assert far_level.periodic_record_launches == launched + 2 * len(levels)


@pytest.mark.gpu
@pytest.mark.parametrize("need_pot", [False, True])
def test_periodic_list_passes_match_plain_on_card(box_setup, need_pot):
    _, pbc, t = box_setup
    tree = box_tree(box_setup)
    lists = box_lists(box_setup, tree)
    ctbl, gt, _, te, gc = eval_inputs(tree, lists)
    valid = te != 1.0
    fkw = dict(tbl=ctbl, ids=lists.far, nf=lists.nf, xc=gt, te=te,
               gc=torch.zeros_like(gc), need_pot=need_pot, pbc=pbc,
               trq=compact_traces(tree, lists))
    nkw = dict(keys=lists.near, n_seg=lists.nn, pos_s=tree.pos_s,
               mass_s=tree.mass_s, eps_s=tree.eps_s, xr=gt, te=te,
               need_pot=need_pot, pbc=pbc)
    for fn, plain, kw in ((far_list, far_list_plain, fkw),
                          (near_level, near_level_plain, nkw)):
        k, p = fn(**kw), plain(**kw)
        assert bool(torch.isfinite(k).all()), fn.__name__
        ea, ep = p999(k, p, valid)
        assert ea < 2e-5, (fn.__name__, ea)
        if need_pot:
            assert ep < 2e-5, (fn.__name__, ep)


@pytest.mark.gpu
@pytest.mark.parametrize("need_pot", [False, True])
def test_far_list_and_near_level_periodic_match_plain_on_card(box_setup,
                                                              need_pot):
    calls = walk_calls(box_setup, need_pot)
    n_far = n_near = 0
    for name, level, kw in calls:
        if name == "far_list":
            k, p = far_list(**kw), far_list_plain(**kw)
            n_far += 1
        elif name == "near_level":
            k, p = near_level(**kw), near_level_plain(**kw)
            n_near += 1
        else:
            continue
        assert bool(torch.isfinite(k).all()), (name, level)
        valid = kw["te"] != 1.0
        if not bool((torch.abs(p[..., :3]) > 0)[valid].any()):
            continue
        ea, ep = p999(k, p, valid)
        assert ea < 2e-5, (name, level, ea)
        if need_pot:
            assert ep < 2e-5, (name, level, ep)
    assert n_far and n_near


@pytest.mark.gpu
@pytest.mark.parametrize("need_pot", [False, True])
def test_direct_periodic_matches_plain_on_card(box_setup, tmp_path,
                                               need_pot):
    cfg, _, t = box_setup
    ew = build_ewald_table(cfg.BoxSize, cache_dir=str(tmp_path),
                           device=t["pos"].device)
    tg = torch.randperm(N, generator=torch.Generator().manual_seed(1))[:512]
    tg = tg.to(t["pos"].device)
    launched = direct_sum.periodic_launches
    ak, pk = direct_sum(t["pos"], t["mass"], t["eps"], targets=tg,
                        with_potential=need_pot, box=cfg.BoxSize, ewald=ew)
    assert direct_sum.periodic_launches == launched + 1
    ap, pp = direct_gravity(t["pos"], t["mass"], t["eps"], targets=tg,
                            with_potential=need_pot, box=cfg.BoxSize,
                            ewald=ew)
    assert q999(scaled(ak, ap)) < 1e-5
    if need_pot:
        assert q999(scaled(pk[:, None], pp[:, None])) < 1e-5


def scaled(a, ref):
    """|a - ref| / max(|ref|, median |ref|) per row (tests/test_pm.py's
    normalisation: a periodic potential can be ~0)."""
    n = torch.linalg.norm(ref.double(), dim=1)
    return torch.linalg.norm((a - ref).double(), dim=1) / torch.clamp(
        n, min=float(torch.quantile(n, 0.5)))


def q999(x) -> float:
    return float(torch.quantile(x, 0.999))
