"""The free-space modes (``PMVacuum``) and the Ewald modes (``PMGrid -1``)
of the walk's kernels against their plain versions on the card (``gpu``
marker: skipped without one; on the card ``python -m pytest tests/ -q -m
gpu -k "vacuum or ewald"``).

An NFW halo (``flagship_ics``, N = 16384) is walked with
``wq_gravity_tree(pbc=(0, alpha, rcut))`` of its free-space mesh (mesh 64,
the reflection sphere x 1.02) and recorded with ``record_lists`` in the
free-space record mode; a small cosmo-box (N = 16384) is walked with
``wq_gravity_tree(ewald=)``. Every ``far_level``, ``far_list`` and
``near_level`` call is repeated on the plain version with the same inputs
(the record mode from the same lists). Bars: far_level's compacted outputs,
counts and lists equal; far_list and near_level p99.9 < 2e-5 on acc and pot,
relative to each target's own in the free-space modes (their erfcf, erff
and expf and sums in another order) and to the call's largest |a| and |pot|
in the Ewald modes (the tile tests' measure: a level's partial lattice
sums nearly cancel for some targets, so relative to a target's own they
show the float32 plain version's own rounding); the periodic direct sum
with the interleaved Ewald table p99.9 < 1e-5 against max(|plain|,
median |plain|). Each call counts one launch of its mode.
This file does not import JAX.
"""

import pytest
import torch

from sidm_tpu_torch.flagship import (cosmo_config, cosmo_ics, flagship_config,
                                     flagship_ics)
from sidm_tpu_torch.ops.direct import direct_gravity, direct_sum
from sidm_tpu_torch.ops.ewald import build_ewald_table
from sidm_tpu_torch.ops.far_kernel import (ListBuf, far_level,
                                           far_level_plain)
from sidm_tpu_torch.ops.far_list import far_list, far_list_plain
from sidm_tpu_torch.ops.fused_force import default_depth
from sidm_tpu_torch.ops.list_force import record_lists
from sidm_tpu_torch.ops.near_kernel import near_level, near_level_plain
from sidm_tpu_torch.ops.pm import build_pm_kernel_free
from sidm_tpu_torch.ops.tree import build_octree
from sidm_tpu_torch.ops.wq_force import wq_gravity_tree

N = 16384
IMAX = 2147483647


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tensors(pos, mass, eps, dev):
    return (torch.tensor(pos, dtype=torch.float32, device=dev),
            torch.tensor(mass, dtype=torch.float32, device=dev),
            torch.full((len(mass),), eps, dtype=torch.float32, device=dev))


@pytest.fixture(scope="module")
def halo(cuda):
    """The halo's tree and its free-space split (0, alpha, rcut)."""
    cfg = flagship_config(PMVacuum=1)
    pos, _, mass = flagship_ics(N, 5)
    kern = build_pm_kernel_free([0.0, 0.0, 0.0],
                                1.02 * cfg.ReflectionBoundary, n=64,
                                device=cuda)
    p, m, e = tensors(pos, mass, cfg.SofteningHalo, cuda)
    tree = build_octree(p, m, e, m > 0, depth=default_depth(N))
    return tree, m, e, (0.0, kern.alpha, kern.rcut)


@pytest.fixture(scope="module")
def box(cuda, tmp_path_factory):
    """A small cosmo-box's tree and its Ewald table."""
    cfg = cosmo_config(N, PMGrid=-1)
    pos, _, mass = cosmo_ics(N, 5)
    p, m, e = tensors(pos, mass, cfg.SofteningHalo, cuda)
    tree = build_octree(p, m, e, m > 0, box=cfg.BoxSize,
                        depth=default_depth(N))
    ew = build_ewald_table(cfg.BoxSize, cache_dir=str(
        tmp_path_factory.mktemp("ew")), device=cuda)
    return tree, m, e, ew


def walk_calls(tree, m, e, **kw):
    calls = []
    wq_gravity_tree(tree, m, e, torch.zeros_like(m), theta=0.5, opening=0,
                    need_pot=True, on_level=lambda name, level, k:
                    calls.append((name, level, dict(k))), **kw)
    return calls


def same_level(k, p, level):
    assert torch.equal(k.cnt, p.cnt), level
    for f, row, tail in (("far", 0, IMAX), ("seg", 1, IMAX),
                         ("fids", 2, -1), ("bkey", 6, IMAX)):
        pv = getattr(p, f)
        if pv is None:
            continue
        live = (torch.arange(pv.shape[1], device=pv.device)[None, :]
                < p.cnt[row][:, None])
        assert torch.equal(torch.where(live, getattr(k, f), tail),
                           torch.where(live, pv, tail)), (level, f)


def p999(a, b, valid, largest=False):
    """p99.9 of the acc and pot errors of a against b over the valid
    targets, relative to each target's own or (largest) to the largest."""
    va, vb = a[valid], b[valid]
    na, npot = torch.linalg.norm(vb[:, :3], dim=1), torch.abs(vb[:, 3])
    if largest:
        na, npot = na.max(), npot.max()
    e = torch.linalg.norm(va[:, :3] - vb[:, :3], dim=1) / torch.clamp(
        na, min=1e-30)
    ep = torch.abs(va[:, 3] - vb[:, 3]) / torch.clamp(npot, min=1e-30)
    return max(float(torch.quantile(e.double(), 0.999)),
               float(torch.quantile(ep.double(), 0.999)))


def check_calls(calls, kind):
    """Every call of a walk against its plain version; each launches its
    ``kind`` mode once (the Ewald modes' errors relative to the call's
    largest)."""
    fns = {"far_level": (far_level, far_level_plain),
           "far_list": (far_list, far_list_plain),
           "near_level": (near_level, near_level_plain)}
    for name, level, kw in calls:
        fn, plain = fns[name]
        n0 = getattr(fn, f"{kind}_launches")
        k, p = fn(**kw), plain(**kw)
        assert getattr(fn, f"{kind}_launches") == n0 + 1, (name, kind)
        if name == "far_level":
            same_level(k, p, level)
        else:
            assert p999(k, p, kw["te"] != 1.0,
                        largest=kind == "ewald") < 2e-5, (name, level)


@pytest.mark.gpu
def test_free_space_walk_matches_plain_on_card(halo):
    tree, m, e, pbc = halo
    calls = walk_calls(tree, m, e, pbc=pbc)
    assert {c[0] for c in calls} == {"far_level", "far_list", "near_level"}
    check_calls(calls, "vacuum")


@pytest.mark.gpu
def test_free_space_record_matches_plain_on_card(halo):
    tree, m, e, pbc = halo
    captured = []

    def spy(level, kw):
        captured.append(dict(kw, lists=ListBuf(*(t.clone()
                                                 for t in kw["lists"]))))

    lists = record_lists(tree, torch.full_like(m, 1e3)[tree.perm],
                         (m > 0)[tree.perm], theta=0.5, use_relative=True,
                         skin=0.5, pbc=pbc, on_level=spy)
    assert sum(lists.ovf.tolist()) == 0 and int(lists.nf.sum()) > 0
    for kw in captured:
        bufs = [ListBuf(*(t.clone() for t in kw["lists"])) for _ in range(2)]
        n0 = far_level.vacuum_record_launches
        k = far_level(**dict(kw, lists=bufs[0]))
        assert far_level.vacuum_record_launches == n0 + 1
        p = far_level_plain(**dict(kw, lists=bufs[1]))
        assert all(torch.equal(a, b) for a, b in zip(*bufs))
        assert torch.equal(k.cnt, p.cnt)


@pytest.mark.gpu
def test_ewald_walk_matches_plain_on_card(box):
    tree, m, e, ew = box
    calls = walk_calls(tree, m, e, ewald=ew)
    assert all(c[2].get("ewald") is ew for c in calls if c[0] != "far_level")
    check_calls(calls, "ewald")


@pytest.mark.gpu
def test_direct_sum_interleaved_table_on_card(box):
    tree, m, e, ew = box
    tg = torch.arange(0, N, 16, device=m.device)
    box_size = ew.box
    for pot in (False, True):
        ak, pk = direct_sum(tree.pos_s, tree.mass_s, tree.eps_s, targets=tg,
                            with_potential=pot, box=box_size, ewald=ew)
        ap, pp = direct_gravity(tree.pos_s, tree.mass_s, tree.eps_s,
                                targets=tg, with_potential=pot, box=box_size,
                                ewald=ew)
        for a, b in ((ak, ap),) + (((pk[:, None], pp[:, None]),)
                                   if pot else ()):
            n = torch.linalg.norm(b.double(), dim=1)
            err = torch.linalg.norm((a - b).double(), dim=1) / torch.clamp(
                n, min=float(torch.quantile(n, 0.5)))
            assert float(torch.quantile(err, 0.999)) < 1e-5
