"""The port's cached interaction lists (``sidm_tpu_torch.ops.list_force``)
and their kernels (``far_list``, ``gather_rows``/``gather_rowsum``, the
record mode of ``far_level``) vs the JAX package.

The JAX side is the frozen output of ``sidm_tpu/ops/list_force.py`` on an
n = 2500 NFW halo (the JAX list test's size), in
tests/data/torch_list_golden.npz (tests/make_torch_golden.py; the JAX
compiles take ~100 s on one CPU, over this file's budget). The ``slow``
test reruns the JAX functions and holds the file to them. The port's tree
is built from the same particles and given the JAX tree's moments, so that
both packages classify the same numbers: its integer structure is the JAX
package's exactly (tests/test_torch_tree.py).

Held: ``record_lists`` at skin 0 and skin 1 gives per-group far and near
sets equal to JAX's and equal nf, nn, pidx, gvalid, src, ovf and need;
``eval_lists`` on JAX's lists carried across and on the port's own, fresh
and after an ``advance_tree`` drift, against JAX ``eval_lists`` with
``materialize`` off and on (the port has only the gather form):
acceleration p99.9 relative error < 2e-5, potential rtol 2e-5 atol 1e-7;
``node_velocities`` within rtol 1e-5 of float64 truth and within JAX's own
float32 error of JAX; ``advance_tree`` and ``max_displacement`` to float32
rounding; tiny caps fire the same overflow counters as JAX and the cap
refit grows them as the JAX Simulation's does (its refits frozen in the
same file). The plain version of ``far_list`` at the Pallas prototype's
shapes is held to ``scripts/pallasfar.py:xla_ref`` by that script's
measure (max |diff| / max |ref| per component < 1e-5; its outputs frozen
in the same file, on the script's own chunk), the plain gathers to numpy
exactly. The kernels are held to their plain versions on the card
(``gpu``)."""

import dataclasses

import numpy as np
import pytest
import torch

from sidm_tpu_torch.ops import fused_force as tff
from sidm_tpu_torch.ops import list_force as tlf
from sidm_tpu_torch.ops.far_kernel import (C_NEXT, ListBuf, far_level,
                                           far_level_plain)
from sidm_tpu_torch.ops.far_list import (far_list, far_list_plain,
                                         far_units, k3_reference)
from sidm_tpu_torch.ops.gather import (gather_rows, gather_rows_plain,
                                       gather_rowsum, gather_rowsum_plain)
from sidm_tpu_torch.ops.tree import build_octree
from tests.make_torch_golden import (LIST_DT, LIST_GOLDEN, LIST_N,
                                     LIST_SKINS, TINY_CAPS, jax_list_ops,
                                     k3_inputs, list_inputs)

torch.set_num_threads(2)

IMAX = tff.IMAX


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(LIST_GOLDEN))


@pytest.fixture(scope="module")
def setup(golden):
    pos, vel, mass, eps, old = (torch.tensor(a) for a in list_inputs())
    valid = torch.ones(LIST_N, dtype=torch.bool)
    tree = build_octree(pos, mass, eps, valid,
                        depth=tff.default_depth(LIST_N))
    jm = torch.tensor(golden["tree_mac_rows"])
    # same integer structure and geometry as the JAX tree (centre, count)
    assert torch.equal(tree.mac_rows[:, 4:8], jm[:, 4:8])
    tree = dataclasses.replace(tree, mac_rows=jm, quad_rows=torch.tensor(
        golden["tree_quad_rows"]))
    return dict(tree=tree, pos=pos, vel=vel, mass=mass, eps=eps, old=old,
                valid=valid)


def _record(setup, skin, lcfg=None):
    t = setup["tree"]
    return tlf.record_lists(
        t, setup["old"][t.perm], setup["valid"][t.perm], theta=0.5,
        use_relative=True, err_tol_force_acc=0.005, lcfg=lcfg, skin=skin,
        vel=setup["vel"], t_now=1.0)


def _jax_lists(golden, prefix):
    return tlf.lists_from_numpy({f: golden[prefix + f]
                                 for f in tlf.InteractionLists._fields})


@pytest.mark.parametrize("i", range(len(LIST_SKINS)))
def test_record_matches_jax(setup, golden, i):
    port = tlf.lists_to_numpy(_record(setup, LIST_SKINS[i]))
    jax = {f: golden[f"s{i}_" + f] for f in tlf.InteractionLists._fields}
    for f in ("nf", "nn", "pidx", "gvalid", "src"):
        np.testing.assert_array_equal(port[f], jax[f], err_msg=f)
    np.testing.assert_array_equal(port["ovf"], jax["ovf"][:4])
    np.testing.assert_array_equal(port["need"], jax["need"][:3])
    assert port["ovf"].sum() == 0 and jax["nf"].max() > 0
    # per-group far and near lists equal as sets
    for f in ("far", "near"):
        np.testing.assert_array_equal(np.sort(port[f], axis=1),
                                      np.sort(jax[f], axis=1), err_msg=f)
    assert float(port["skin"]) == LIST_SKINS[i]
    np.testing.assert_array_equal(port["pos_ref"], setup["tree"].pos_s)


def _rel_err(a, b):
    return (np.linalg.norm(a - b, axis=1)
            / np.maximum(np.linalg.norm(b, axis=1), 1e-30))


@pytest.fixture(scope="module")
def port_eval(setup, golden):
    """The port's (acc, pot) by (lists source, fresh or advanced tree),
    each evaluated once and held to both JAX modes."""
    cache = {}

    def get(source, when):
        if (source, when) not in cache:
            lists = (_jax_lists(golden, "s1_") if source == "jax"
                     else _record(setup, LIST_SKINS[1]))
            tree = setup["tree"]
            if when == "adv":
                pos2 = setup["pos"] + LIST_DT * setup["vel"]
                tree = tlf.advance_tree(tree, lists, pos2, 1.0 + LIST_DT)
            cache[source, when] = tlf.eval_lists(
                tree, lists, setup["mass"], setup["eps"], need_pot=True)
        return cache[source, when]
    return get


@pytest.mark.parametrize("when", ["fresh", "adv"])
@pytest.mark.parametrize("mode", ["gather", "mat"])
@pytest.mark.parametrize("source", ["jax", "port"])
def test_eval_matches_jax(port_eval, golden, source, mode, when):
    """The port's gather form against JAX with materialize off and on."""
    acc, pot = port_eval(source, when)
    ref_a = golden[f"eval_{when}_{mode}_acc"]
    ref_p = golden[f"eval_{when}_{mode}_pot"]
    assert np.quantile(_rel_err(acc.numpy(), ref_a), 0.999) < 2e-5
    np.testing.assert_allclose(pot.numpy(), ref_p, rtol=2e-5, atol=1e-7)


def _exact_vcom(tree, vel):
    v = vel.double().numpy()[tree.perm.numpy()]
    m = tree.mass_s.double().numpy()
    c = np.concatenate([np.zeros((1, 4)),
                        np.cumsum(np.column_stack([m[:, None] * v, m *
                                                   np.linalg.norm(v, axis=1)]),
                                  axis=0)])
    a = tree.node_start.numpy().astype(np.int64)
    s = c[a + tree.node_count.numpy()] - c[a]
    mn = np.maximum(tree.mac_rows[:, 3].double().numpy(), 1e-30)
    return s[:, :3] / mn[:, None], s[:, 3] / mn


def test_node_velocities(setup, golden):
    tree = setup["tree"]
    port = tlf.node_velocities(tree, setup["vel"]).numpy()
    jax = golden["s1_vcom"]
    exact, scale = _exact_vcom(tree, setup["vel"])
    live = tree.node_count.numpy() > 0
    scale = 1e-5 * scale[live, None]
    port, jax, exact = port[live], jax[live], exact[live]
    assert np.all(np.abs(port - exact) <= scale)
    assert np.all(np.abs(port - jax) <= np.abs(jax - exact) + scale)


def test_advance_tree(setup, golden):
    """JAX's lists (and so JAX's vcom) on the JAX moments: the drifted
    centres of mass are JAX's to float32 rounding; positions are the
    predicted ones in sorted order, the rest unchanged."""
    tree = setup["tree"]
    lists = _jax_lists(golden, "s1_")
    pos2 = setup["pos"] + LIST_DT * setup["vel"]
    adv = tlf.advance_tree(tree, lists, pos2, 1.0 + LIST_DT)
    np.testing.assert_array_equal(adv.pos_s, pos2[tree.perm])
    mac, ref = adv.mac_rows.numpy(), golden["adv_mac"]
    np.testing.assert_array_equal(mac[:, 3:], ref[:, 3:])
    np.testing.assert_allclose(mac[:, :3], ref[:, :3], rtol=0,
                               atol=1e-6 * float(tree.extent))
    assert torch.equal(adv.quad_rows, tree.quad_rows)


def test_max_displacement(setup):
    tree = setup["tree"]
    lists = _record(setup, LIST_SKINS[1])
    pos2 = setup["pos"] + LIST_DT * setup["vel"]
    md = float(tlf.max_displacement(lists, pos2[tree.perm]))
    exact = np.max(np.linalg.norm(
        (pos2 - setup["pos"]).double().numpy(), axis=1))
    np.testing.assert_allclose(md, exact, rtol=1e-5)
    assert md > 0


def test_overflow_counters_fire(setup, golden):
    lists = tlf.lists_to_numpy(_record(setup, 0.0,
                                       tlf.ListConfig(**TINY_CAPS)))
    np.testing.assert_array_equal(lists["ovf"], golden["tiny_ovf"][:4])
    np.testing.assert_array_equal(lists["need"], golden["tiny_need"][:3])
    for f in ("nf", "nn", "src"):
        np.testing.assert_array_equal(lists[f], golden["tiny_" + f])
    for f in ("far", "near"):
        np.testing.assert_array_equal(np.sort(lists[f], axis=1),
                                      np.sort(golden["tiny_" + f], axis=1))
    assert lists["ovf"][0] > 0 and lists["ovf"][1] > 0
    assert lists["ovf"][2] > 0 and lists["ovf"][3] > 0


def test_refit_grows_caps_as_jax(golden):
    """Simulation._refit_list_caps against the JAX Simulation's, from the
    tiny caps' demand: the same far, near and used caps three times, then
    exhaustion. The level cap deliberately differs (ROADMAP C.8): the
    port's Simulation records with none, JAX grows its 3072 to the
    narrower list cap (the JAX refits frozen as ``refit_grew`` and
    ``refit_caps`` [far, near, used, level])."""
    from sidm_tpu_torch.config import SimConfig
    from sidm_tpu_torch.flagship import FLAGSHIP
    from sidm_tpu_torch.simulation import Simulation

    port = Simulation(SimConfig(**FLAGSHIP), mode="phased", device="cpu")
    port._lfc = tlf.ListConfig(**{**TINY_CAPS, "lvl_cap": None})
    need = golden["tiny_need"]
    for k in range(4):
        grew = port._refit_list_caps(need[:3])
        assert grew == bool(golden["refit_grew"][k]) == (k < 3)
        if grew:
            far, near, used, lvl = (int(c) for c in golden["refit_caps"][k])
            assert port._lfc == tlf.ListConfig(far_cap=far, near_cap=near,
                                               used_cap=used)
            assert lvl == min(far, near)
            need = need * 2


def _max_rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def test_far_units_plain_matches_xla_ref(golden):
    """K3's own interface (NU = 2048 units of 32 rows) through the plain
    far_list against the script's XLA reference, by its measure
    (scripts/pallasfar.py:240-242); the PyTorch transcription of that
    reference agrees with it as closely (its sums run in another order)."""
    rows, tgt = k3_inputs()
    ref = [golden[f"k3_ref{c}"] for c in range(4)]
    out = far_units(torch.tensor(rows), torch.tensor(tgt))   # plain: CPU
    tr = k3_reference(torch.tensor(rows), torch.tensor(tgt))
    for a, b, r in zip(out, tr, ref):
        assert a.shape == r.shape
        assert _max_rel(a.numpy(), r) < 1e-5
        assert _max_rel(b.numpy(), r) < 1e-5


def test_far_list_cpu_runs_plain(setup):
    lists = _record(setup, 0.0)
    n0 = far_list.launches
    tree = setup["tree"]
    ctbl = gather_rows(tff.flat_tables(tff.pack_tree(tree)), torch.cat(
        [lists.src, torch.tensor([tree.mac_rows.shape[0]],
                                 dtype=torch.int32)]))
    ng = lists.nf.shape[0]
    xc = torch.zeros(ng, 64, 3)
    te = torch.ones(ng, 64)
    gc = torch.zeros(ng, 3)
    a = far_list(ctbl, lists.far, lists.nf, xc, te, gc, need_pot=True)
    b = far_list_plain(ctbl, lists.far, lists.nf, xc, te, gc, need_pot=True)
    assert far_list.launches == n0
    assert torch.equal(a, b)
    assert torch.all(ctbl[-1] == 0)


@pytest.mark.parametrize("m", [1, 300])
def test_gather_plain_matches_numpy(m):
    rng = np.random.default_rng(m)
    tbl = rng.standard_normal((m, 16)).astype(np.float32)
    ids = rng.integers(0, m + 1, (7, 33)).astype(np.int32)
    ids[0, 0] = m
    ext = np.concatenate([tbl, np.zeros((1, 16), np.float32)])
    n0 = (gather_rows.launches, gather_rowsum.launches)
    rows = gather_rows(torch.tensor(tbl), torch.tensor(ids))
    sums = gather_rowsum(torch.tensor(tbl), torch.tensor(ids))
    assert (gather_rows.launches, gather_rowsum.launches) == n0
    np.testing.assert_array_equal(rows.numpy(), ext[ids])
    assert np.all(rows.numpy()[0, 0] == 0)
    np.testing.assert_allclose(sums.numpy(), ext[ids].sum(-1, keepdims=True),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(gather_rows_plain(torch.tensor(tbl),
                                         torch.tensor(ids)), rows)
    assert torch.equal(gather_rowsum_plain(torch.tensor(tbl),
                                           torch.tensor(ids)), sums)


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """The committed golden file is what the JAX list functions give now."""
    live = jax_list_ops()
    assert sorted(live) == sorted(golden)
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)


# ---- on the card: each kernel against its plain version -----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _to(x, dev):
    return x.to(dev) if isinstance(x, torch.Tensor) else x


@pytest.mark.gpu
def test_far_level_record_kernel_matches_plain_on_card(setup, cuda):
    """Every level of the recording walk, from the same list state: the
    lists, their counts and telemetry, the next frontier and the counts
    equal."""
    captured = []

    def spy(**kw):
        captured.append(dict(kw, lists=ListBuf(*(t.clone()
                                                  for t in kw["lists"]))))
        return far_level_plain(**kw)

    import sidm_tpu_torch.ops.list_force as mod
    orig = mod.far_level
    mod.far_level = spy
    try:
        _record(setup, LIST_SKINS[1])
    finally:
        mod.far_level = orig
    assert len(captured) > 3
    for kw in captured:
        kw = {k: _to(v, cuda) for k, v in kw.items()}
        bufs = [ListBuf(*(_to(t, cuda) for t in kw["lists"]))
                for _ in range(2)]
        n0 = far_level.record_launches
        k = far_level(**dict(kw, lists=bufs[0]))
        assert far_level.record_launches == n0 + 1
        p = far_level_plain(**dict(kw, lists=bufs[1]))
        for a, b in zip(*bufs):
            assert torch.equal(a, b)
        assert torch.equal(k.cnt, p.cnt)
        if p.fids is not None:
            live = (torch.arange(p.fids.shape[1], device=cuda)
                    < p.cnt[C_NEXT][:, None])
            assert torch.equal(torch.where(live, k.fids, -1), p.fids)


@pytest.mark.gpu
@pytest.mark.parametrize("need_pot", [False, True])
def test_far_list_kernel_matches_plain_on_card(setup, cuda, need_pot):
    lists = tlf.lists_from_numpy(tlf.lists_to_numpy(
        _record(setup, LIST_SKINS[1])), cuda)
    tree = setup["tree"]
    M = tree.mac_rows.shape[0]
    tbl = tff.flat_tables(tff.pack_tree(tree)).to(cuda)
    src = torch.cat([lists.src, torch.tensor([M], dtype=torch.int32,
                                             device=cuda)])
    ctbl = gather_rows_plain(tbl, src)
    gt = tree.pos_s.to(cuda)[lists.pidx]
    gc = gt.mean(1)
    xc = (gt - gc[:, None]).contiguous()
    te = torch.full(xc.shape[:2], 0.3, device=cuda)
    n0 = far_list.launches
    a = far_list(ctbl, lists.far, lists.nf, xc, te, gc, need_pot=need_pot)
    assert far_list.launches == n0 + 1
    b = far_list_plain(ctbl, lists.far, lists.nf, xc, te, gc,
                       need_pot=need_pot)
    v = lists.gvalid
    assert np.quantile(_rel_err(a[..., :3][v].cpu().numpy(),
                                b[..., :3][v].cpu().numpy()), 0.999) < 2e-5
    np.testing.assert_allclose(a[..., 3].cpu(), b[..., 3].cpu(), rtol=2e-5,
                               atol=1e-7)


@pytest.mark.gpu
def test_far_units_kernel_matches_reference_on_card(cuda):
    rows, tgt = (torch.tensor(a, device=cuda) for a in k3_inputs())
    for a, r in zip(far_units(rows, tgt), k3_reference(rows, tgt)):
        assert _max_rel(a.cpu().numpy(), r.cpu().numpy()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 1 << 10, 1 << 14])
def test_gather_kernels_match_plain_on_card(cuda, m):
    g = torch.Generator(device="cpu").manual_seed(m)
    tbl = torch.randn(m, 16, generator=g).to(cuda)
    ids = torch.randint(0, m + 1, (257, 33), generator=g,
                        dtype=torch.int32).to(cuda)
    assert torch.equal(gather_rows(tbl, ids), gather_rows_plain(tbl, ids))
    torch.testing.assert_close(gather_rowsum(tbl, ids),
                               gather_rowsum_plain(tbl, ids), rtol=1e-6,
                               atol=1e-5)
