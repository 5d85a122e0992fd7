"""The port of the Pallas far kernel (``sidm_tpu_torch.ops.far_kernel``)
vs JAX ``pallas_far.far_items`` in interpret mode, on one level of a
JAX-built tree carried across as numpy, for a subset of target groups.

Per-group [ax ay az] agree to p99.9 relative error < 2e-5 and the
potential to rtol 2e-5, atol 1e-7 (float32 sums in another order); the
segment, open and big key planes are exactly equal. Covered: an inner
level and the last level, both opening criteria, with and without the
potential. On the card (``gpu`` marker) the CUDA kernel is held against
the plain version the same way.

The list-far kernel's work-item split (``ops/work_items.py``) covers every
live list entry once, in order, in items of about equal size; the plain
``far_list_plain`` evaluated item by item and summed in the second pass's
order matches it on the whole lists to 1e-6 relative; on the card the
kernel (and its split) is held against the plain version on lists with
an empty list beside one at the cap, dead ids and softened pairs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidm_tpu.io import ics
from sidm_tpu.ops import fused_force as jff
from sidm_tpu.ops.pallas_far import far_items, pack_rows_t, pack_tgt_scal
from sidm_tpu.ops.tree import build_octree as jbuild

from sidm_tpu_torch.ops.direct import direct_gravity
from sidm_tpu_torch.ops.far_kernel import far_level, far_level_plain

torch.set_num_threads(2)

N, DEPTH, G, WC = 2048, 8, 64, 128
IMAX = 2147483647


def groups_of_tree(n_groups=8, seed=7):
    """JAX tree + packed levels + the inputs of a subset of target groups,
    built as wq_force.wq_gravity_tree builds them (numpy float32)."""
    pos, _, m = ics.plummer(N, seed=seed)
    pos, m = pos.astype(np.float32), m.astype(np.float32)
    m[::61] = 0.0                        # a few invalid particles
    eps = np.full(N, 0.05, np.float32)
    jt = jbuild(jnp.asarray(pos), jnp.asarray(m), jnp.asarray(eps),
                jnp.asarray(m > 0), depth=DEPTH)
    ft = jff.pack_tree(jt)
    perm = np.asarray(jt.perm)
    pidx, gvalid, *_ = jff.make_windows(jt.keys_s, jnp.asarray((m > 0)[perm]),
                                        N, G, DEPTH, 4, 32, True)
    pidx, gvalid = np.asarray(pidx), np.asarray(gvalid)
    pick = np.linspace(0, int(np.any(gvalid, 1).sum()) - 1, n_groups)
    pidx, gvalid = pidx[pick.astype(int)], gvalid[pick.astype(int)]
    acc, _ = direct_gravity(torch.tensor(pos), torch.tensor(m),
                            torch.tensor(eps), with_potential=False)
    toac = (np.linalg.norm(acc.numpy(), axis=1)[perm] * 0.005).astype(
        np.float32)
    pos_s = np.asarray(jt.pos_s)
    xr = pos_s[pidx]
    te = np.where(gvalid, np.asarray(jt.eps_s)[pidx], 1.0).astype(np.float32)
    goac = np.where(gvalid, toac[pidx], 0.0)
    glo = np.where(gvalid[..., None], xr, 1e30).min(1).astype(np.float32)
    ghi = np.where(gvalid[..., None], xr, -1e30).max(1).astype(np.float32)
    pos_oac = gvalid & (goac > 0)
    oac = np.where(pos_oac.any(1),
                   np.where(pos_oac, goac, 1e30).min(1), 0.0).astype(
                       np.float32)
    gc = (np.float32(0.5) * (glo + ghi)).astype(np.float32)
    xc = np.where(gvalid[..., None], xr - gc[:, None, :], 0.0).astype(
        np.float32)
    return dict(jt=jt, ft=ft, xr=xr, xc=xc, te=te, glo=glo, ghi=ghi,
                oac=oac, gvalid=gvalid)


@pytest.fixture(scope="module")
def setup():
    return groups_of_tree()


def level_inputs(s, level):
    """All nodes of ``level`` as every group's frontier."""
    tbl = np.asarray(s["ft"].levels[level])
    W = tbl.shape[0]
    ng = s["xc"].shape[0]
    s_l = np.float32(float(s["jt"].extent) / (1 << level))
    return dict(fids=np.tile(np.arange(W, dtype=np.int32), (ng, 1)),
                n_live=np.full(ng, W, np.int32), tbl=tbl,
                nl_real=int(s["ft"].n_levels[level]), s_l=s_l, xc=s["xc"],
                te=s["te"], glo=s["glo"], ghi=s["ghi"], oac=s["oac"])


def jax_far(inp, *, theta2, use_relative, leaf_cap, last, need_pot):
    """far_items (interpret mode) over the (group, 128-chunk) items."""
    fids, tbl = inp["fids"], inp["tbl"]
    ng, W = fids.shape
    nc = W // WC
    g_of = np.repeat(np.arange(ng, dtype=np.int32), nc)
    ids = fids.reshape(ng * nc, WC)
    dead = (ids < 0) | (ids >= inp["nl_real"])
    rows = tbl[np.clip(ids, 0, tbl.shape[0] - 1)]
    rows_t = pack_rows_t(jnp.asarray(rows), jnp.asarray(ids),
                         jnp.asarray(dead))
    tgt, scal = pack_tgt_scal(jnp.asarray(inp["xc"]), jnp.asarray(inp["te"]),
                              jnp.zeros((ng, G, 3), jnp.float32),
                              jnp.asarray(inp["glo"]),
                              jnp.asarray(inp["ghi"]),
                              jnp.asarray(inp["oac"]))
    acc, keys = far_items(jnp.asarray(g_of), jnp.asarray(inp["s_l"]), rows_t,
                          tgt, scal, G=G, WC=WC, theta2=theta2,
                          use_relative=use_relative, leaf_cap=leaf_cap,
                          last=last,
                          need_pot=need_pot, interpret=True)
    keys = np.asarray(keys).reshape(ng, nc, 4, WC).transpose(2, 0, 1, 3)
    return np.asarray(acc)[:ng, :, :4], keys[:3].reshape(3, ng, W)


def port_far(fn, inp, device, **kw):
    t = {k: (torch.tensor(v).to(device) if isinstance(v, np.ndarray)
             else v) for k, v in inp.items()}
    t["s_l"] = torch.tensor(inp["s_l"]).to(device)
    acc, *keys = fn(**t, **kw)
    return acc.cpu().numpy(), np.stack([k.cpu().numpy() for k in keys])


def assert_acc_close(a, b, valid):
    """p99.9 of per-target |a-b|/|b| < 2e-5 on [ax ay az]; potential rtol
    2e-5, atol 1e-7."""
    va, vb = a[..., :3][valid], b[..., :3][valid]
    err = np.linalg.norm(va - vb, axis=1) / np.maximum(
        np.linalg.norm(vb, axis=1), 1e-30)
    assert np.quantile(err, 0.999) < 2e-5, np.quantile(err, 0.999)
    np.testing.assert_allclose(a[..., 3][valid], b[..., 3][valid],
                               rtol=2e-5, atol=1e-7)


# (level, last, use_relative, need_pot, leaf_cap); level 5 run as the last
# level has overfull cells, so big keys are emitted
CASES = [(3, False, False, True, 16), (3, False, True, False, 16),
         (5, True, True, True, 16), (DEPTH, True, False, False, 16)]


@pytest.mark.parametrize("level,last,use_relative,need_pot,leaf_cap", CASES)
def test_far_level_matches_pallas(setup, level, last, use_relative,
                                  need_pot, leaf_cap):
    inp = level_inputs(setup, level)
    kw = dict(theta2=0.25, use_relative=use_relative, leaf_cap=leaf_cap,
              last=last, need_pot=need_pot)
    acc_j, keys_j = jax_far(inp, **kw)
    acc_t, keys_t = port_far(far_level, inp, "cpu", **kw)
    np.testing.assert_array_equal(keys_t, keys_j)
    assert (keys_j[0] != IMAX).any()
    assert (keys_j[1] != IMAX).any() != last
    if level == 5:
        assert (keys_j[2] != IMAX).any()
    assert_acc_close(acc_t, acc_j, setup["gvalid"])
    if not need_pot:
        assert np.all(acc_t[..., 3] == 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("level,last,use_relative,need_pot,leaf_cap", CASES)
def test_far_kernel_matches_plain_on_card(setup, cuda, level, last,
                                          use_relative, need_pot, leaf_cap):
    inp = level_inputs(setup, level)
    kw = dict(theta2=0.25, use_relative=use_relative, leaf_cap=leaf_cap,
              last=last, need_pot=need_pot)
    n0 = far_level.launches
    acc_k, keys_k = port_far(far_level, inp, cuda, **kw)
    assert far_level.launches == n0 + 1
    acc_p, keys_p = port_far(far_level_plain, inp, cuda, **kw)
    np.testing.assert_array_equal(keys_k, keys_p)
    assert_acc_close(acc_k, acc_p, setup["gvalid"])


def test_far_level_cpu_runs_plain(setup):
    inp = level_inputs(setup, 3)
    kw = dict(theta2=0.25, use_relative=False, leaf_cap=16, last=False,
              need_pot=True)
    n0 = far_level.launches
    a = port_far(far_level, inp, "cpu", **kw)
    b = port_far(far_level_plain, inp, "cpu", **kw)
    assert far_level.launches == n0
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


# ---- far_list's work-item split (ops/work_items.py) ------------------------

def far_lists(LF=700, nf=(0, 700, 300, 0, 17, 750), rows=300, seed=14):
    """A compact table (rows + 1 zero row) and lists of row ids: an empty
    list, one at the cap LF, one past it (clamped), dead ids (-1, out of
    range, the zero row); a few nodes inside the softening length."""
    rng = np.random.default_rng(seed)
    ng = len(nf)
    tbl = np.zeros((rows + 1, 16), np.float32)
    tbl[:rows, 0:3] = rng.normal(0.0, 3.0, (rows, 3))
    tbl[:5, 0:3] = rng.normal(0.0, 0.05, (5, 3))
    tbl[:rows, 3] = rng.uniform(0.5, 1.5, rows) / rows
    tbl[:rows, 8:14] = rng.normal(0.0, 1e-3, (rows, 6)) * tbl[:rows, 3:4]
    tbl[:rows, 14] = 0.05
    ids = rng.integers(0, rows + 1, (ng, LF)).astype(np.int32)
    ids[:, ::37] = -1
    ids[:, 5::41] = rows + 7
    xc = rng.normal(0.0, 0.3, (ng, G, 3)).astype(np.float32)
    te = np.full((ng, G), 0.05, np.float32)
    te[:, 60:] = 1.0                      # dead target slots
    xc[:, 60:] = 0.0
    gc = rng.normal(0.0, 0.1, (ng, 3)).astype(np.float32)
    return dict(tbl=tbl, ids=ids, nf=np.asarray(nf, np.int32), xc=xc, te=te,
                gc=gc)


FAR_SPLIT_CASES = {"cap": (700, (0, 700, 300, 0, 17, 750)),
                   "single": (64, (40,)),
                   "over_room": (300000, (300000, 299999))}


@pytest.mark.parametrize("name", list(FAR_SPLIT_CASES))
def test_far_split_covers_entries_in_order(name):
    """Every live entry (below min(nf, LF)) of every list lies in exactly
    one item, a group's items are consecutive ranges in order, and the
    items are about equal in size."""
    from sidm_tpu_torch.ops.far_list import far_split
    from sidm_tpu_torch.ops.work_items import FAR_E_MIN, item_cap

    LF, nf = FAR_SPLIT_CASES[name]
    nf = np.asarray(nf, np.int32)
    ng = len(nf)
    s = {k: v.numpy() for k, v in far_split(torch.tensor(nf), LF).items()}
    n_items = len(s["item_g"])
    assert n_items <= item_cap(ng) and s["off"][-1] == n_items
    np.testing.assert_array_equal(
        s["item_g"], np.repeat(np.arange(ng), np.diff(s["off"])))
    for g in range(ng):
        w = min(int(nf[g]), LF)
        its = np.arange(s["off"][g], s["off"][g + 1])
        if w == 0:
            assert len(its) == 0
            continue
        assert s["e0"][its[0]] == 0 and s["e1"][its[-1]] == w
        np.testing.assert_array_equal(s["e1"][its[:-1]], s["e0"][its[1:]])
        size = s["e1"][its] - s["e0"][its]
        assert np.all(size > 0) and np.all(size <= s["unit"][g])
    if name == "single":
        assert n_items == 1
    if name == "cap":
        assert np.diff(s["off"])[1] > 1
    if name == "over_room":
        assert s["unit"][0] > FAR_E_MIN     # E grew to keep the item cap


def far_items_plain(inp, need_pot):
    """far_list_plain evaluated item by item (each item as a list of its
    own entries) and summed in the second pass's order, in float64: the
    random nodes pull the targets from all sides, and float32 sums in
    another order differ by ~1e-6 of a target's small net force."""
    from sidm_tpu_torch.ops.far_list import far_list_plain, far_split
    from sidm_tpu_torch.ops.work_items import sum_items

    t = {k: torch.tensor(v.astype(np.float64) if v.dtype == np.float32
                         else v) for k, v in inp.items()}
    LF = inp["ids"].shape[1]
    s = far_split(t["nf"], LF)
    g = s["item_g"]
    size = s["e1"] - s["e0"]
    width = int(size.max())
    col = s["e0"][:, None] + torch.arange(width)
    ids = t["ids"][g[:, None], torch.clamp(col, max=LF - 1)]
    part = far_list_plain(t["tbl"], ids, size.int(), t["xc"][g], t["te"][g],
                          t["gc"][g], need_pot=need_pot)
    return sum_items(part, s["off"]).numpy(), len(g)


@pytest.mark.parametrize("need_pot", [True, False])
def test_far_list_items_sum_matches_plain(need_pot):
    from sidm_tpu_torch.ops.far_list import far_list_plain

    inp = far_lists()
    acc_i, n_items = far_items_plain(inp, need_pot)
    assert n_items > 4
    t = {k: torch.tensor(v.astype(np.float64) if v.dtype == np.float32
                         else v) for k, v in inp.items()}
    acc_p = far_list_plain(**t, need_pot=need_pot).numpy()
    valid = inp["te"] != 1.0
    valid[inp["nf"] == 0] = False
    a, b = acc_i[..., :3][valid], acc_p[..., :3][valid]
    err = np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)
    assert err.max() < 1e-6, err.max()
    np.testing.assert_allclose(acc_i[..., 3][valid], acc_p[..., 3][valid],
                               rtol=1e-6)
    assert np.all(acc_i[[0, 3]] == 0) and np.all(acc_p[[0, 3]] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("need_pot", [True, False])
def test_far_list_kernel_stress_on_card(cuda, need_pot):
    """The lists above on the card: an empty list beside one at the cap,
    dead ids, softened pairs."""
    from sidm_tpu_torch.ops.far_list import far_list, far_list_plain

    inp = far_lists()
    t = {k: torch.tensor(v).to(cuda) for k, v in inp.items()}
    n0 = far_list.launches
    acc_k = far_list(**t, need_pot=need_pot).cpu().numpy()
    assert far_list.launches == n0 + 1
    acc_p = far_list_plain(**t, need_pot=need_pot).cpu().numpy()
    valid = inp["te"] != 1.0
    valid[inp["nf"] == 0] = False
    assert np.all(np.isfinite(acc_k))
    assert_acc_close(acc_k, acc_p, valid)
    assert np.all(acc_k[[0, 3]] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FAR_SPLIT_CASES))
def test_far_split_kernel_matches_plain_on_card(cuda, name):
    from sidm_tpu_torch.ops.far_list import far_split

    LF, nf = FAR_SPLIT_CASES[name]
    nf = torch.tensor(np.asarray(nf, np.int32))
    a, b = far_split(nf.to(cuda), LF), far_split(nf, LF)
    for k in ("unit", "off", "item_g", "e0", "e1"):
        np.testing.assert_array_equal(a[k].cpu().numpy(), b[k].numpy())
