"""The port of the Pallas near kernel (``sidm_tpu_torch.ops.near_kernel``)
vs JAX ``pallas_near.near_items`` in interpret mode, on the same segment
keys over the same sorted particles (JAX's outputs frozen in
tests/data/torch_near_golden.npz, tests/make_torch_golden.py ``near``;
the ``slow`` test reruns JAX and holds the file to them).

Per-group [ax ay az] agree to p99.9 relative error < 2e-5 and the
potential to rtol 2e-5, atol 1e-7. The keys include each group's own
segment (self pairs give zero force) and a window across the end of the
valid particles (zero-mass padding inside a segment contributes nothing).
On the card (``gpu`` marker) the CUDA kernel is held against the plain
version the same way, also on stress inputs (a group at the near cap
beside empty groups, self and coincident pairs).

The kernel's work-item split (``ops/work_items.py``) covers every live
key once, in order, without splitting a key, in items of about equal
covered-particle count; the plain version evaluated item by item and
summed in the second pass's order matches ``near_level_plain`` to 1e-6
relative; on the card the kernel's own split equals the plain one."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sidm_tpu_torch.ops.near_kernel import near_level, near_level_plain
from sidm_tpu_torch.ops.tree import level_offsets
from tests.make_torch_golden import (NEAR_GOLDEN, NEAR_LEVEL,
                                     near_level_setup)
from tests.make_torch_golden import jax_near as jax_near_live

torch.set_num_threads(2)

N, DEPTH, G, SC, K = (NEAR_LEVEL["n"], NEAR_LEVEL["depth"], 64, 16,
                      NEAR_LEVEL["k"])
IMAX = 2147483647


@pytest.fixture(scope="module")
def setup():
    """Sorted particles of a Plummer tree (with zero-mass padding sorted
    last), 8 target groups and K segment keys per group (the group's own
    leaf, random others and a window across the end of the valid
    particles: tests/make_torch_golden.py ``near_level_setup``)."""
    tree, xr, te, gvalid, keys, n_seg = near_level_setup()
    return SimpleNamespace(tree=tree, xr=xr, te=te, gvalid=gvalid, keys=keys,
                           n_seg=n_seg)


@pytest.fixture(scope="module")
def golden():
    with np.load(NEAR_GOLDEN) as z:
        return {k: z[k] for k in z.files}


def jax_near(golden, need_pot):
    """JAX's near_items on the setup's keys, frozen."""
    return golden[f"acc{int(need_pot)}"]


def port_near(fn, s, device, need_pot, keys=None, n_seg=None):
    t = s.tree
    keys = s.keys if keys is None else keys
    n_seg = s.n_seg if n_seg is None else n_seg
    return fn(torch.tensor(keys).to(device), torch.tensor(n_seg).to(device),
              t.pos_s.to(device), t.mass_s.to(device), t.eps_s.to(device),
              torch.tensor(s.xr).to(device), torch.tensor(s.te).to(device),
              need_pot=need_pot).cpu().numpy()


def assert_acc_close(a, b, valid):
    va, vb = a[..., :3][valid], b[..., :3][valid]
    err = np.linalg.norm(va - vb, axis=1) / np.maximum(
        np.linalg.norm(vb, axis=1), 1e-30)
    assert np.quantile(err, 0.999) < 2e-5, np.quantile(err, 0.999)
    np.testing.assert_allclose(a[..., 3][valid], b[..., 3][valid],
                               rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("need_pot", [True, False])
def test_near_level_matches_pallas(setup, golden, need_pot):
    acc_j = jax_near(golden, need_pot)
    acc_t = port_near(near_level, setup, "cpu", need_pot)
    assert_acc_close(acc_t, acc_j, setup.gvalid)
    if not need_pot:
        assert np.all(acc_t[..., 3] == 0)


def test_self_pair_and_padding(setup):
    """A target's own one-particle segment gives exactly zero force and the
    spline self potential -m/eps; a window of zero-mass padding gives 0."""
    t = setup.tree
    ng = setup.keys.shape[0]
    p0 = int(np.flatnonzero(setup.gvalid[0])[0])
    me = int(np.flatnonzero(
        (t.pos_s.numpy() == setup.xr[0, p0]).all(1))[0])
    nv = int((t.mass_s > 0).sum())
    keys = np.full((ng, K), IMAX, np.int32)
    keys[0, 0] = me * 32 + 1
    keys[1, 0] = nv * 32 + 16 if nv + 16 <= N else (N - 4) * 32 + 4
    n_seg = np.array([1, 1] + [0] * (ng - 2), np.int32)
    acc = port_near(near_level, setup, "cpu", True, keys, n_seg)
    assert np.all(acc[0, p0, :3] == 0.0)
    m, e = float(t.mass_s[me]), float(t.eps_s[me])
    np.testing.assert_allclose(acc[0, p0, 3], -m / e, rtol=1e-6)
    assert np.all(acc[1] == 0.0) and np.all(acc[2:] == 0.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("need_pot", [True, False])
def test_near_kernel_matches_plain_on_card(setup, cuda, need_pot):
    n0 = near_level.launches
    acc_k = port_near(near_level, setup, cuda, need_pot)
    assert near_level.launches == n0 + 1
    acc_p = port_near(near_level_plain, setup, cuda, need_pot)
    assert_acc_close(acc_k, acc_p, setup.gvalid)


# ---- the work-item split (ops/work_items.py) -------------------------------

def split_case(name):
    """(keys, n_seg) of one edge case of the split: groups with 0 keys,
    a group at the cap (K keys of cnt 31), IMAX keys inside and after the
    live prefix, a single item, and more covered particles than the item
    cap's room at the least item size."""
    rng = np.random.default_rng(11)
    if name == "single":
        keys = np.full((1, 8), IMAX, np.int32)
        keys[0, :3] = [5 * 32 + 3, 40 * 32 + 31, 90 * 32 + 1]
        return keys, np.array([3], np.int32)
    if name == "over_room":
        K = 20000
        keys = (np.arange(2 * K, dtype=np.int64).reshape(2, K) * 32
                + 31).astype(np.int32)
        return keys, np.array([K, K], np.int32)
    K = 512
    ng = 6
    keys = np.full((ng, K), IMAX, np.int32)
    n_seg = np.zeros(ng, np.int32)
    for g in range(ng):
        n = {0: 0, 1: K, 2: 300, 3: 0, 4: 40, 5: K + 7}[g]
        cnt = rng.integers(1, 32, min(n, K))
        if g == 1 and name == "cap":
            cnt[:] = 31
        keys[g, :len(cnt)] = rng.integers(0, 1 << 20, len(cnt)) * 32 + cnt
        n_seg[g] = n
    if name == "imax_tail":
        keys[2, 100:110] = IMAX       # dead keys inside the live prefix
        keys[4, :] = IMAX             # a live prefix of dead keys only
    return keys, n_seg


SPLIT_CASES = ["cap", "imax_tail", "single", "over_room"]


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_near_split_covers_keys_in_order(name):
    """Every live key of a group that covers particles lies in exactly
    one item, the items
    of a group are consecutive key ranges in order, no key is split, and
    the items are about equal in covered particles."""
    from sidm_tpu_torch.ops.near_kernel import near_split
    from sidm_tpu_torch.ops.work_items import NEAR_P_MIN, item_cap

    keys, n_seg = split_case(name)
    ng, K = keys.shape
    s = {k: v.numpy() for k, v in near_split(torch.tensor(keys),
                                              torch.tensor(n_seg)).items()}
    nseg = np.clip(n_seg, 0, K)
    live = np.arange(K)[None, :] < nseg[:, None]
    cnt = np.where(live & (keys != IMAX), keys & 31, 0)
    n_items = len(s["item_g"])
    assert n_items <= item_cap(ng)
    assert s["off"][-1] == n_items and np.all(np.diff(s["off"]) >= 0)
    assert np.all(np.diff(s["item_g"]) >= 0)
    np.testing.assert_array_equal(
        s["item_g"], np.repeat(np.arange(ng), np.diff(s["off"])))
    seen = np.zeros_like(keys, dtype=np.int64)
    for g in range(ng):
        its = np.arange(s["off"][g], s["off"][g + 1])
        if cnt[g].sum() == 0:
            assert len(its) == 0
            continue
        assert s["k0"][its[0]] == 0 and s["k1"][its[-1]] == nseg[g]
        np.testing.assert_array_equal(s["k1"][its[:-1]], s["k0"][its[1:]])
        for i in its:
            assert s["k0"][i] < s["k1"][i]
            seen[g, s["k0"][i]:s["k1"][i]] += 1
            cov = cnt[g, s["k0"][i]:s["k1"][i]].sum()
            assert 0 < cov <= s["unit"][g] + 30
        assert s["unit"][g] >= min(NEAR_P_MIN, cnt[g].sum()) // 2
    # a group whose live keys cover nothing (all IMAX) has no items
    np.testing.assert_array_equal(
        seen, (live & (cnt.sum(1) > 0)[:, None]).astype(np.int64))
    if name == "cap":
        assert np.diff(s["off"])[1] > 1 and np.all(
            cnt[1, :nseg[1]] == 31)
    if name == "single":
        assert n_items == 1
    if name == "over_room":
        assert s["unit"][0] > NEAR_P_MIN     # P grew to keep the item cap


def items_plain(setup, keys, n_seg, need_pot):
    """near_level_plain evaluated item by item (each item as a group of
    its own keys) and summed in the second pass's order."""
    from sidm_tpu_torch.ops.near_kernel import near_split
    from sidm_tpu_torch.ops.work_items import sum_items

    s = near_split(torch.tensor(keys), torch.tensor(n_seg))
    n_items = len(s["item_g"])
    width = -(-int(torch.max(s["k1"] - s["k0"])) // SC) * SC
    ikeys = np.full((n_items, width), IMAX, np.int32)
    for i in range(n_items):
        k0, k1 = int(s["k0"][i]), int(s["k1"][i])
        ikeys[i, :k1 - k0] = keys[int(s["item_g"][i]), k0:k1]
    t = setup.tree
    g = s["item_g"].numpy()
    part = near_level_plain(
        torch.tensor(ikeys), (s["k1"] - s["k0"]).int(), t.pos_s, t.mass_s,
        t.eps_s, torch.tensor(setup.xr[g]), torch.tensor(setup.te[g]),
        need_pot=need_pot)
    return sum_items(part, s["off"]).numpy(), n_items


def long_keys(setup, K=1024):
    """K leaf keys per group (several items each), one group empty."""
    t = setup.tree
    offs = level_offsets(N, DEPTH)
    start = t.node_start[offs[DEPTH]:].numpy()
    cnt = t.node_count[offs[DEPTH]:].numpy()
    leaves = np.flatnonzero((cnt > 0) & (cnt <= 31))
    rng = np.random.default_rng(12)
    ng = setup.keys.shape[0]
    keys = np.full((ng, K), IMAX, np.int32)
    n_seg = np.full(ng, K, np.int32)
    for g in range(ng):
        pick = rng.choice(leaves, K)
        keys[g] = start[pick] * 32 + cnt[pick]
    n_seg[3] = 0
    return keys, n_seg


@pytest.mark.parametrize("need_pot", [True, False])
def test_near_items_sum_matches_plain(setup, need_pot):
    keys, n_seg = long_keys(setup)
    acc_i, n_items = items_plain(setup, keys, n_seg, need_pot)
    assert n_items > keys.shape[0]
    acc_p = port_near(near_level_plain, setup, "cpu", need_pot, keys, n_seg)
    valid = setup.gvalid
    a, b = acc_i[..., :3][valid], acc_p[..., :3][valid]
    err = np.linalg.norm(a - b, axis=1) / np.maximum(
        np.linalg.norm(b, axis=1), 1e-30)
    assert err.max() < 1e-6, err.max()
    np.testing.assert_allclose(acc_i[..., 3][valid], acc_p[..., 3][valid],
                               rtol=1e-6)
    assert np.all(acc_i[3] == 0) and np.all(acc_p[3] == 0)


def stress_near(setup, K=8192):
    """Group 0 at the near cap (K keys of cnt 31) beside empty groups 1 and
    3; group 2 holds its targets' own particles (self pairs) and 32
    particles moved onto its first target (coincident pairs); the rest
    keep the setup's keys. Returns (keys, n_seg, pos_s)."""
    t = setup.tree
    ng = setup.keys.shape[0]
    rng = np.random.default_rng(13)
    keys = np.full((ng, K), IMAX, np.int32)
    n_seg = np.zeros(ng, np.int32)
    keys[0] = rng.integers(0, N - 31, K) * 32 + 31
    n_seg[0] = K
    pos = t.pos_s.clone()
    p0 = int(np.flatnonzero(setup.gvalid[2])[0])
    pos[100:132] = torch.tensor(setup.xr[2, p0])
    own = np.flatnonzero((t.pos_s.numpy()[:, None, :]
                          == setup.xr[2][None, :, :]).all(-1).any(1))
    ks = [100 * 32 + 31, 131 * 32 + 1] + [int(p) * 32 + 1 for p in own]
    keys[2, :len(ks)] = ks
    n_seg[2] = len(ks)
    for g in range(4, ng):
        keys[g, :K] = np.concatenate([setup.keys[g], np.full(
            K - setup.keys.shape[1], IMAX, np.int32)])
        n_seg[g] = setup.n_seg[g]
    return keys, n_seg, pos


@pytest.mark.gpu
@pytest.mark.parametrize("need_pot", [True, False])
def test_near_kernel_stress_on_card(setup, cuda, need_pot):
    keys, n_seg, pos = stress_near(setup)
    t = setup.tree
    args = [torch.tensor(keys).to(cuda), torch.tensor(n_seg).to(cuda),
            pos.to(cuda), t.mass_s.to(cuda), t.eps_s.to(cuda),
            torch.tensor(setup.xr).to(cuda), torch.tensor(setup.te).to(cuda)]
    acc_k = near_level(*args, need_pot=need_pot).cpu().numpy()
    acc_p = near_level_plain(*args, need_pot=need_pot).cpu().numpy()
    assert np.all(np.isfinite(acc_k))
    assert_acc_close(acc_k, acc_p, setup.gvalid)
    assert np.all(acc_k[[1, 3]] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", SPLIT_CASES)
def test_near_split_kernel_matches_plain_on_card(cuda, name):
    from sidm_tpu_torch.ops.near_kernel import near_split

    keys, n_seg = split_case(name)
    a = near_split(torch.tensor(keys).to(cuda), torch.tensor(n_seg).to(cuda))
    b = near_split(torch.tensor(keys), torch.tensor(n_seg))
    for k in ("cov", "unit", "off", "item_g", "k0", "k1"):
        np.testing.assert_array_equal(a[k].cpu().numpy(), b[k].numpy())


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """The committed golden file is what JAX's near_items gives now."""
    live = jax_near_live()
    assert sorted(live) == sorted(golden)
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
