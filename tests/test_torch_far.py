"""The port of the Pallas far kernel (``sidm_tpu_torch.ops.far_kernel``)
vs JAX ``pallas_far.far_items`` in interpret mode, on one level of a
JAX-built tree carried across as numpy, for a subset of target groups.

Walk mode: the walk's far field of the level (``far_list`` on the
compacted far ids, as ``wq_force._wq_eval`` evaluates it) agrees with
``far_items``' per-group [ax ay az] to p99.9 relative error < 2e-5 and the
potential to rtol 2e-5, atol 1e-7 (float32 sums in another order); the
compacted outputs (far ids, segment keys, next frontier, big-cell
chunk keys) and every count are exactly JAX's key planes put through
JAX's own ``compact_plane``, ``_expand_open_wq`` and the walk's big path.
Record mode: the lists after appending one level to part-full lists, the
next frontier, the demand and the drops are exactly JAX's
``_walk_level_keys`` planes through ``compact_plane``, ``_append_plane``
and ``_expand_open_wq``. Covered: an inner level and the last level, both
opening criteria, with and without the potential, frontiers of unequal
widths, and a case for each cap (``open_cap``, the next frontier's
width, ``lvl_cap``, ``far_cap``, ``near_cap``, ``big_cap`` and
``big_chunks``) overflowing. On the card (``gpu`` marker) the CUDA kernel
is held against the plain version (walk, with the far field by the
``far_list`` kernel against ``far_list_plain``) and against JAX (record)
the same way.

JAX's outputs are frozen in tests/data/torch_far_golden.npz (``python -m
tests.make_torch_golden far``: the tree, the interpreted ``far_items`` and
the recording walk's level).

The list-far kernel's work-item split (``ops/work_items.py``) covers every
live list entry once, in order, in items of about equal size; the plain
``far_list_plain`` evaluated item by item and summed in the second pass's
order matches it on the whole lists to 1e-6 relative; on the card the
kernel (and its split) is held against the plain version on lists with
an empty list beside one at the cap, dead ids and softened pairs."""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.ops.far_kernel import (C_BIG, C_BIG_DROP, C_BK, C_FAR,
                                           C_NEXT, C_OPEN, C_OVF_OPEN, C_SEG,
                                           S_NEED_F, S_NEED_N, S_OVF_F,
                                           S_OVF_L, S_OVF_N, ListBuf,
                                           far_level, far_level_plain)
from sidm_tpu_torch.ops.far_list import far_list, far_list_plain
from tests.make_torch_golden import (FAR, FAR_CASES, FAR_DEFAULT_CAPS,
                                     FAR_GOLDEN, FAR_LVL_BASE,
                                     FAR_RECORD_CASES, far_level_inputs,
                                     prefilled_lists)

torch.set_num_threads(2)

N, DEPTH, G, WC = FAR["n"], FAR["depth"], FAR["g"], FAR["wc"]
IMAX = 2147483647


@pytest.fixture(scope="module")
def golden():
    with np.load(FAR_GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def setup(golden):
    """The JAX tree's levels and the inputs of a subset of its target
    groups (``f_``), built as wq_force.wq_gravity_tree builds them."""
    return {k[2:]: v for k, v in golden.items() if k.startswith("f_")}


level_inputs = far_level_inputs


def port_level(fn, inp, device, lists=None, **kw):
    """``fn`` (far_level or far_level_plain) on numpy inputs (the
    targets xc and te are the far field's, not read here)."""
    t = {k: (torch.tensor(v).to(device) if isinstance(v, np.ndarray)
             else v) for k, v in inp.items() if k not in ("xc", "te")}
    t["s_l"] = torch.tensor(inp["s_l"]).to(device)
    return fn(**t, **kw, lists=lists)


def walk_far_field(fn, out, inp, device, need_pot):
    """The level's far field as ``wq_force._wq_eval`` evaluates it:
    ``fn`` (far_list or far_list_plain) on the compacted far ids of
    ``out`` against the group-centred targets."""
    t = {k: torch.tensor(inp[k]).to(device)
         for k in ("tbl", "xc", "te", "glo", "ghi")}
    return fn(t["tbl"], out.far, out.cnt[C_FAR], t["xc"], t["te"],
              0.5 * (t["glo"] + t["ghi"]), need_pot=need_pot)


def assert_prefix(x, n, ref, tail=IMAX):
    """Row g of x holds ref's first n[g] entries, and ref holds only
    ``tail`` after them: a compacted output against JAX's compacted plane
    (the entries of x past n[g] are not looked at)."""
    x, n = x.cpu().numpy(), np.asarray(n.cpu() if torch.is_tensor(n) else n)
    live = np.arange(ref.shape[1])[None, :] < n[:, None]
    assert x.shape == ref.shape
    np.testing.assert_array_equal(np.where(live, x, tail), ref)


def assert_acc_close(a, b, valid):
    """p99.9 of per-target |a-b|/|b| < 2e-5 on [ax ay az]; potential rtol
    2e-5, atol 1e-7."""
    va, vb = a[..., :3][valid], b[..., :3][valid]
    err = np.linalg.norm(va - vb, axis=1) / np.maximum(
        np.linalg.norm(vb, axis=1), 1e-30)
    assert np.quantile(err, 0.999) < 2e-5, np.quantile(err, 0.999)
    np.testing.assert_allclose(a[..., 3][valid], b[..., 3][valid],
                               rtol=2e-5, atol=1e-7)


DEFAULT_CAPS = FAR_DEFAULT_CAPS
CASES = FAR_CASES


def walk_kw(last, use_relative, leaf_cap, caps):
    return dict(theta2=0.25, use_relative=use_relative, leaf_cap=leaf_cap,
                last=last, **caps)


@pytest.mark.parametrize("level,last,use_relative,need_pot,leaf_cap,caps",
                         CASES)
def test_far_level_matches_pallas(setup, golden, level, last, use_relative,
                                  need_pot, leaf_cap, caps):
    """The walk mode against JAX: the compacted far ids, segment keys,
    next frontier and big-cell chunks and every count as JAX's key planes
    through ``compact_plane``, ``_expand_open_wq`` and the walk's big path
    give them; the far field of the far ids as ``far_items`` gives it."""
    inp = level_inputs(setup, level, short=9)
    kw = walk_kw(last, use_relative, leaf_cap, caps)
    i = CASES.index((level, last, use_relative, need_pot, leaf_cap, caps))
    j = {k.split("_", 1)[1]: v for k, v in golden.items()
         if k.startswith(f"c{i}_")}
    acc_j = j["acc"]
    out = port_level(far_level, inp, "cpu", **kw)
    cnt = out.cnt.numpy()
    assert_prefix(out.far, cnt[C_FAR], j["far"])
    assert_prefix(out.seg, cnt[C_SEG], j["seg"])
    np.testing.assert_array_equal(cnt[C_FAR], j["n_far"])
    np.testing.assert_array_equal(cnt[C_SEG], j["n_seg"])
    assert cnt[C_SEG].sum() > 0
    if not last:
        fids, n_live, ovf, n_open = (j[k] for k in ("fids", "n_live", "ovf",
                                                    "n_open"))
        assert_prefix(out.fids, cnt[C_NEXT], fids, tail=-1)
        np.testing.assert_array_equal(cnt[C_NEXT], n_live)
        np.testing.assert_array_equal(cnt[C_OPEN], n_open)
        assert cnt[C_OVF_OPEN].sum() == ovf
        assert n_open.sum() > 0
        assert (ovf > 0) == (caps["open_cap"] < 1024)
    else:
        bkey, n_bk, n_big, bcnt = (j[k] for k in ("bkey", "n_bk", "n_big",
                                                  "bcnt"))
        assert_prefix(out.bkey, cnt[C_BK], bkey)
        np.testing.assert_array_equal(cnt[C_BK], n_bk)
        np.testing.assert_array_equal(cnt[C_BIG], n_big)
        np.testing.assert_array_equal(
            cnt[C_BIG_DROP],
            np.sum(np.maximum(bcnt - 16 * caps["big_chunks"], 0), 1))
        if level == 5:
            assert n_big.max() > caps["big_cap"]
            assert cnt[C_BIG_DROP].sum() > 0
        assert np.all(cnt[C_OPEN] == 0)
    acc = walk_far_field(far_list, out, inp, "cpu", need_pot).numpy()
    assert_acc_close(acc, acc_j, setup["gvalid"])
    if not need_pot:
        assert np.all(acc[..., 3] == 0)


LVL_BASE = FAR_LVL_BASE
RECORD_CASES = FAR_RECORD_CASES


def record_case(setup, golden, name, device, fn):
    """One record-mode level on prefilled lists: the port's (Level,
    ListBuf) and JAX's composition of the same level (a dict: JAX
    ``_record``'s do_level, then ``_expand_open`` or the big path)."""
    level, last, caps, (LF, LN, lvl_cap) = RECORD_CASES[name]
    inp = level_inputs(setup, level, short=9)
    ng, W = inp["fids"].shape
    far0, near0, nf0, nn0 = prefilled_lists(ng, LF, LN, seed=level)
    jkw = dict(theta2=0.25, use_relative=True, leaf_cap=16, last=last)
    pre = f"r{name}_"
    jax = {k[len(pre):]: (v if v.ndim else v.item())
           for k, v in golden.items() if k.startswith(pre)}
    buf = ListBuf(*(torch.tensor(a).to(device) for a in
                    (far0, near0, nf0, nn0)),
                  stat=torch.zeros(5, ng, dtype=torch.int32, device=device))
    n0 = far_level.record_launches
    out = port_level(fn, inp, device, lists=buf, lvl_base=LVL_BASE,
                     lvl_cap=lvl_cap, **jkw, **caps)
    launched = far_level.record_launches - n0
    return out, buf, jax, launched


def assert_record_equal(out, buf, jax, last):
    for f in ("far", "near", "nf", "nn"):
        np.testing.assert_array_equal(getattr(buf, f).cpu().numpy(), jax[f],
                                      err_msg=f)
    st = buf.stat.cpu().numpy()
    np.testing.assert_array_equal(st[S_NEED_F], jax["need_f"])
    np.testing.assert_array_equal(st[S_NEED_N], jax["need_n"])
    assert [int(st[S_OVF_L].sum()), int(st[S_OVF_F].sum()),
            int(st[S_OVF_N].sum())] == [jax["ovf_l"], jax["ovf_f"],
                                        jax["ovf_n"]]
    if not last:
        cnt = out.cnt.cpu().numpy()
        assert_prefix(out.fids, cnt[C_NEXT], jax["fids"], tail=-1)
        np.testing.assert_array_equal(cnt[C_NEXT], jax["n_live"])


@pytest.mark.parametrize("name", list(RECORD_CASES))
def test_far_level_record_matches_jax(setup, golden, name):
    """The record mode against JAX: the level's accepted flat ids and
    segment keys (and big-cell chunks) appended to part-full lists as JAX's
    ``_walk_level_keys`` planes through ``compact_plane`` and
    ``_append_plane`` append them, the next frontier as
    ``_expand_open_wq`` gives it, and the same demand and drops, with the
    cap the case is named after overflowing."""
    out, buf, jax, _ = record_case(setup, golden, name, "cpu", far_level)
    last = RECORD_CASES[name][1]
    assert_record_equal(out, buf, jax, last)
    fired = {"open_cap": jax.get("ovf_open", 0), "wn": jax.get("ovf_open", 0),
             "lvl_cap": jax["ovf_l"], "far_cap": jax["ovf_f"],
             "near_cap": jax["ovf_n"], "big_cap": jax.get("over", 0)}
    assert fired[name] > 0, (name, jax["ovf_l"], jax["ovf_f"], jax["ovf_n"])
    if name not in ("open_cap", "wn", "lvl_cap", "big_cap"):
        assert jax["ovf_l"] == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("level,last,use_relative,need_pot,leaf_cap,caps",
                         CASES)
def test_far_kernel_matches_plain_on_card(setup, cuda, level, last,
                                          use_relative, need_pot, leaf_cap,
                                          caps):
    inp = level_inputs(setup, level, short=9)
    kw = walk_kw(last, use_relative, leaf_cap, caps)
    n0 = far_level.launches
    k = port_level(far_level, inp, cuda, **kw)
    assert far_level.launches == n0 + 1
    p = port_level(far_level_plain, inp, cuda, **kw)
    np.testing.assert_array_equal(k.cnt.cpu().numpy(), p.cnt.cpu().numpy())
    for f, row, tail in (("far", C_FAR, IMAX), ("seg", C_SEG, IMAX),
                         ("fids", C_NEXT, -1), ("bkey", C_BK, IMAX)):
        if getattr(p, f) is not None:
            assert_prefix(getattr(k, f), p.cnt[row],
                          getattr(p, f).cpu().numpy(), tail=tail)
    n0 = far_list.launches
    acc_k = walk_far_field(far_list, k, inp, cuda, need_pot)
    assert far_list.launches == n0 + 1
    acc_p = walk_far_field(far_list_plain, p, inp, cuda, need_pot)
    assert_acc_close(acc_k.cpu().numpy(), acc_p.cpu().numpy(),
                     setup["gvalid"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(RECORD_CASES))
def test_far_level_record_kernel_matches_jax_on_card(setup, golden, cuda,
                                                     name):
    out, buf, jax, launched = record_case(setup, golden, name, cuda,
                                          far_level)
    assert launched == 1
    assert_record_equal(out, buf, jax, RECORD_CASES[name][1])


def test_far_level_cpu_runs_plain(setup):
    inp = level_inputs(setup, 3)
    kw = walk_kw(False, False, 16, DEFAULT_CAPS)
    n0 = far_level.launches
    a = port_level(far_level, inp, "cpu", **kw)
    b = port_level(far_level_plain, inp, "cpu", **kw)
    assert far_level.launches == n0
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)


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
    from sidm_tpu_torch.ops.far_list import far_split
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
