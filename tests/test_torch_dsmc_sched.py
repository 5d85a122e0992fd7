"""The schedule and the contracts of the port's two DSMC pair kernels,
the candidate emission ``list_range.sidm_emit`` (``csrc/sidm_emit.cu``,
both modes) and the walk's segment pass ``fused_range.sidm_near``
(``csrc/sidm_near.cu``), at a small size with no JAX.

The emission takes its groups most staged particles first
(``fused_range.group_order`` over ``segment_totals``, whose kernel is
``cover_count`` in ``csrc/work_items.cuh``) and skips the batches of 32
staged particles a target cannot reach, which its bound counts
(``bounds.emit_batches``, ``emit_reach``); the segment pass cuts its
groups into work items by their (live slot, staged particle) pairs
(``fused_range.near_pairs``, ``work_items.plan_items`` with p_min
``fused_range.NEAR_PIECE``) and gives threads only to a group's live
slots (``fused_range.live_slots``).
The inputs are made from
a seed with numpy: 8192 particles sorted by x, so that an id window is a
slab of space, and groups whose keys (start*32+cnt, 1-31 particles, some
IMAX, some groups with nn past the key width or none) cover windows of
very different lengths; groups with all 64 slots live, one, 13 and none.
On the CPU the wrappers run their plain versions, which are held here to
a brute force in numpy written from the contract, in float32 with the
same order of operations:

* the emission: every row's ids in key order then particle order, cut
  at K (5 truncates, 384 does not), its count and uncapped demand; rows
  no slot owns IMAX with counts 0; the count mode's counts
  (non-pending, sqrt(r^2) < h); with and without a periodic box. Exact.
* the segment pass: neighbour counts exact, dead and ungated slots (0, 0,
  -inf, -1), a partner only among the group's staged ids.

On the card (``gpu``): each kernel against its plain version on the same
inputs, the longest groups, a one-live and an all-live group among them:
the emission and the totals bit-equal; the segment pass's counts, best
keys and partners equal, P_tot to rtol 1e-5 (the kernel sums in another
order).
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch import bounds
from sidm_tpu_torch.ops import fused_range as tfr
from sidm_tpu_torch.ops import list_range as tlr
from sidm_tpu_torch.ops.fused_force import IMAX
from sidm_tpu_torch.ops.sidm import SidmParams

torch.set_num_threads(2)

N, NG, L, G = 8192, 16, 64, 64
LIVE = (64, 1, 13, 0)       # live slots of group g: LIVE[g % 4]
BOX = 1.0
F32 = np.float32


def _inputs(box: float = 0.0):
    """Numpy inputs of both kernels: (rows (N, 8) [pos3 vel3 mass aux],
    keys (NG, L), nn, gt, gv, gr, gh, gdt, gty, gidx)."""
    rng = np.random.default_rng(17 if box else 16)
    pos = rng.uniform(0, box or 1.0, (N, 3))
    pos = pos[np.argsort(pos[:, 0])]
    aux = rng.integers(1, 3, N) + 8 * (rng.random(N) < 0.1)
    rows = np.concatenate([pos, rng.normal(0, 1, (N, 3)),
                           rng.uniform(0.5, 1.5, (N, 1)) / N, aux[:, None]],
                          axis=1).astype(F32)
    keys = np.full((NG, L), IMAX, np.int32)
    nn = np.zeros(NG, np.int32)
    gidx = np.full((NG, G), -1, np.int32)
    ids = rng.permutation(N)
    for g in range(NG):
        # an id window (a slab) of its own length; group 1 takes the two
        # ends of the id range (the faces x = 0 and x = box)
        width = int(rng.integers(64, 1200))
        w0 = int(rng.integers(0, N - width))
        nk = [L, L + 9, int(rng.integers(1, L)), 0][g % 4] if g else L
        nn[g] = nk
        nk = min(nk, L)
        st = rng.integers(w0, w0 + width - 31, nk)
        if g == 1:
            st = np.where(np.arange(nk) % 2, rng.integers(0, 200, nk),
                          rng.integers(N - 231, N - 31, nk))
        cnt = rng.integers(1, 32, nk)
        keys[g, :nk] = np.where(rng.random(nk) < 0.1, IMAX, st * 32 + cnt)
        lo = st.min() if nk else w0
        mine = ids[(ids >= lo) & (ids < lo + width)][:LIVE[g % 4]]
        ids = np.setdiff1d(ids, mine, assume_unique=True)
        rng.shuffle(ids)
        gidx[g, :len(mine)] = mine
    dead = gidx < 0
    tid = np.maximum(gidx, 0)
    gt = np.where(dead[..., None], 0, rows[tid, :3] + rng.normal(
        0, 0.01, (NG, G, 3))).astype(F32)
    if box:
        gt = np.mod(gt, box).astype(F32)
    gv = np.where(dead[..., None], 0, rows[tid, 3:6]).astype(F32)
    gr = np.where(dead, 0, rng.uniform(0.04, 0.09, (NG, G))).astype(F32)
    # the groups of 13 targets hold one without a radius (ungated)
    ungated = np.zeros((NG, G), bool)
    ungated[2::4, 5] = True
    gh = np.where(dead | ungated, 0,
                  rng.uniform(0.05, 0.08, (NG, G))).astype(F32)
    gdt = np.where(dead, 0, rng.uniform(0.5, 1.0, (NG, G))).astype(F32)
    gty = np.where(dead, -9, rng.integers(1, 3, (NG, G))).astype(np.int32)
    return rows, keys, nn, gt, gv, gr, gh, gdt, gty, gidx


def _staged(keys, nn, g):
    """The sorted ids group g stages, in key order then particle order."""
    out = []
    for key in keys[g, :max(0, min(int(nn[g]), keys.shape[1]))]:
        if key != IMAX:
            out.extend(range(key >> 5, (key >> 5) + (key & 31)))
    return np.asarray(out, np.int64)


def _r2(t, s, box):
    d = [t[c] - s[:, c] for c in range(3)]
    if box:
        b = F32(box)
        d = [x - b * np.round(x / b) for x in d]
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def _emit_ref(keys, nn, src, gt, gr, gty, gidx, K, count_mode, box):
    cand = np.full((N, K), IMAX, np.int32)
    ncand = np.zeros(N, np.int32)
    needk = np.zeros(N, np.int32)
    for g in range(NG):
        ids = _staged(keys, nn, g)
        s = src[ids]
        for k in range(G):
            me = gidx[g, k]
            if me < 0:
                continue
            r2 = _r2(gt[g, k], s, box)
            ok = (np.mod(s[:, 3], F32(8)).astype(np.int32) == gty[g, k]) \
                & (ids != me)
            if count_mode:
                ncand[me] = np.sum(ok & (np.sqrt(r2) < gr[g, k])
                                   & (s[:, 3] < 8))
                continue
            hit = ids[ok & (r2 < gr[g, k] * gr[g, k])]
            needk[me] = len(hit)
            ncand[me] = min(len(hit), K)
            cand[me, :ncand[me]] = hit[:K]
    return ncand if count_mode else (cand, ncand, needk)


def _torch(*xs):
    return [torch.tensor(x) for x in xs]


def _emit_args(box):
    rows, keys, nn, gt, _, gr, _, _, gty, gidx = _inputs(box)
    src = np.ascontiguousarray(rows[:, [0, 1, 2, 7]])
    return (keys, nn, src, gt, gr, gty, gidx)


def _near_args(box):
    rows, keys, nn, gt, gv, _, gh, gdt, gty, gidx = _inputs(box)
    params = SidmParams(5e2, 0, 1.0, 1.0, 0.0, 30, 2, False, 0.1, 0.0, 0.0)
    return (keys, nn, rows, gt, gv, gh, gdt, gty, gidx), params


def test_segment_totals_count_the_staged_particles():
    keys, nn = _inputs()[1:3]
    tot = tfr.segment_totals(*_torch(keys, nn))
    assert tot.dtype == torch.int32
    ref = [len(_staged(keys, nn, g)) for g in range(NG)]
    np.testing.assert_array_equal(tot.numpy(), ref)
    # the same as segment_particles' valid particles
    _, val = tfr.segment_particles(*_torch(keys, nn))
    np.testing.assert_array_equal(tot.numpy(), val.sum(1).numpy())
    assert tot[3] == 0 and nn[5] > L and max(ref) > 2 * min(ref[:3])


def test_group_order_takes_the_longest_groups_first():
    keys, nn = _torch(*_inputs()[1:3])
    tot = tfr.segment_totals(keys, nn).numpy()
    order = tfr.group_order(keys, nn)
    assert order.dtype == torch.int32
    o = order.numpy()
    np.testing.assert_array_equal(np.sort(o), np.arange(NG))
    assert np.all(np.diff(tot[o]) <= 0)
    tie = np.diff(tot[o]) == 0
    assert np.all(np.diff(o)[tie] > 0)      # ties in index order
    assert o[0] == int(np.argmax(tot))


def test_live_slots_are_the_targets_with_a_radius():
    _, _, _, _, _, _, gh, _, _, gidx = _inputs()
    live = tfr.live_slots(*_torch(gidx, gh)).numpy()
    np.testing.assert_array_equal(live, ((gidx >= 0) & (gh > 0)).sum(1))
    assert live.dtype == np.int32
    # all 64, one, 13 with one ungated, none
    np.testing.assert_array_equal(live, [(64, 1, 12, 0)[g % 4]
                                         for g in range(NG)])


def test_near_pairs_weigh_the_groups_by_live_slot_pairs():
    _, keys, nn, _, _, _, gh, _, _, gidx = _inputs()
    w = tfr.near_pairs(*_torch(keys, nn, gidx, gh))
    assert w.dtype == torch.int32
    ref = [len(_staged(keys, nn, g)) * int(((gidx[g] >= 0)
                                            & (gh[g] > 0)).sum())
           for g in range(NG)]
    np.testing.assert_array_equal(w.numpy(), ref)
    # no live slot or no key: no work item; the heaviest group is cut
    from sidm_tpu_torch.ops.work_items import item_cap, plan_items
    _, off, _ = plan_items(w, IMAX, item_cap(NG), 2000)
    n_it = (off[1:] - off[:-1]).numpy()
    np.testing.assert_array_equal(n_it == 0, np.asarray(ref) == 0)
    assert n_it.max() > 1 and n_it[int(np.argmax(ref))] == n_it.max()


def _rounds_ref(keys, nn):
    """Per group its staged ids cut into batches, from the rounds of
    ``csrc/seg_rounds.cuh`` written out key by key."""
    out = []
    for g in range(keys.shape[0]):
        nk = max(0, min(int(nn[g]), keys.shape[1]))
        c0, batches = 0, []
        while c0 < nk:
            ids, t = [], 0
            while t < 512 and c0 + t < nk:
                key = int(keys[g, c0 + t])
                c = 0 if key == IMAX else key & 31
                if len(ids) + c > 2048:
                    break
                ids.extend(range(key >> 5, (key >> 5) + c))
                t += 1
            batches.extend(ids[i:i + 32] for i in range(0, len(ids), 32))
            c0 += t
        out.append(batches)
    return out


def test_emit_batches_follow_the_kernels_rounds():
    rng = np.random.default_rng(5)
    ng, lk = 5, 700
    keys = (rng.integers(0, 10 ** 6, (ng, lk)) * 32
            + rng.integers(1, 32, (ng, lk))).astype(np.int32)
    keys[rng.random((ng, lk)) < 0.05] = IMAX
    keys[1, :600] = 31 + 32 * np.arange(600)   # 512 keys, then 2048
    nn = np.asarray([lk, 600, 3, 0, lk + 5], np.int32)
    ids, batch, bgroup = bounds.emit_batches(*_torch(keys, nn))
    ref = _rounds_ref(keys, nn)
    flat = [b for bs in ref for b in bs]
    np.testing.assert_array_equal(ids.numpy(), np.concatenate(flat))
    np.testing.assert_array_equal(
        np.bincount(batch.numpy()), [len(b) for b in flat])
    np.testing.assert_array_equal(
        bgroup.numpy(), np.repeat(np.arange(ng), [len(b) for b in ref]))
    assert min(len(b) for b in flat) < 32 and len(ref[1]) > 600 * 31 // 32


def test_emit_reach_keeps_every_hit():
    """No hit lies in a (batch, slot) the emission skips, the bound counts
    the pairs of the others only, and with a periodic box all."""
    keys, nn, src, gt, gr, gty, gidx = _emit_args(0.0)
    reach, size, bgroup = bounds.emit_reach(*_torch(keys, nn, src, gt, gr,
                                                    gidx))
    ids, batch, _ = bounds.emit_batches(*_torch(keys, nn))
    ids, batch, reach = ids.numpy(), batch.numpy(), reach.numpy()
    bg = bgroup.numpy()
    hits = 0
    for g in range(NG):
        mine = bg[batch] == g
        s = src[ids[mine]]
        for k in np.flatnonzero(gidx[g] >= 0):
            r2 = _r2(gt[g, k], s, 0.0)
            hit = r2 < gr[g, k] * gr[g, k]
            hits += int(hit.sum())
            assert reach[batch[mine][hit], k].all(), (g, k)
    assert not reach[gidx[bg] < 0].any()
    counts = {}
    bounds.emit_work(*_torch(keys, nn, src, gt, gr, gidx), N, 384,
                     counts=counts)
    assert hits > 1000
    assert counts["reach_pairs"] < counts["pairs"], counts
    assert counts["reach_pairs"] == int((reach * size.numpy()[:, None]).sum())
    boxed = {}
    bounds.emit_work(*_torch(keys, nn, src, gt, gr, gidx), N, 384,
                     box=BOX, counts=boxed)
    assert boxed["reach_pairs"] == boxed["pairs"] == counts["pairs"]


@pytest.mark.parametrize("box", [0.0, BOX])
@pytest.mark.parametrize("K", [384, 5])
def test_emission_rows_in_staged_order(box, K):
    args = _emit_args(box)
    got = tlr.sidm_emit(*_torch(*args), N, K, box=box)
    ref = _emit_ref(*args, K, False, box)
    for a, b, f in zip(got, ref, ("cand", "ncand", "needk")):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    owned = np.zeros(N, bool)
    owned[args[-1][args[-1] >= 0]] = True
    assert np.all(got[0].numpy()[~owned] == IMAX)
    assert (ref[2] > K).any() == (K == 5) and ref[2].sum() > 1000


@pytest.mark.parametrize("box", [0.0, BOX])
def test_count_mode_counts_non_pending_within_h(box):
    args = _emit_args(box)
    got = tlr.count_neighbours(*_torch(*args), N, box=box)
    ref = _emit_ref(*args, 0, True, box)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 500


@pytest.mark.parametrize("box", [0.0, BOX])
def test_near_plain_on_sparse_and_full_groups(box):
    args, params = _near_args(box)
    keys, nn, rows, gt, gv, gh, gdt, gty, gidx = args
    ptot, ncnt, bestk, bestj = tfr.sidm_near(
        *_torch(*args), 7, torch.tensor(0.05), torch.tensor(5e2), params,
        box)
    live = (gidx >= 0) & (gh > 0)
    for g in range(NG):
        ids = _staged(keys, nn, g)
        s = rows[ids]
        for k in range(G):
            if not live[g, k]:
                assert ptot[g, k] == 0 and ncnt[g, k] == 0
                assert bestk[g, k] == float("-inf") and bestj[g, k] == -1
                continue
            r = np.sqrt(_r2(gt[g, k], s, box))
            ok = (ids != gidx[g, k]) & (r < gh[g, k]) & (s[:, 7] < 8) \
                & (np.mod(s[:, 7], F32(8)).astype(np.int32) == gty[g, k])
            assert ncnt[g, k] == ok.sum(), (g, k)
            assert (bestj[g, k] >= 0) == bool(ok.any())
            if ok.any():
                assert int(bestj[g, k]) in set(ids[ok].tolist())
    assert int(ncnt.sum()) > 500 and bool((ptot > 0).any())


# --------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _near_ties(k, j, pk, pj):
    """Partners that differ, and how many at a near-tie (keys within 4
    ULPs)."""
    diff = j != pj
    fin = np.isfinite(pk)
    gap = np.full(pk.shape, np.inf, np.float32)
    gap[fin] = np.abs(k[fin] - pk[fin])
    tie = diff & (gap <= 4 * np.spacing(np.abs(pk).astype(np.float32)))
    return int(diff.sum()), int(tie.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("box,piece", [(0.0, None), (BOX, None),
                                       (0.0, 2000), (BOX, 500)])
def test_sidm_emit_and_near_kernels_match_plain_on_card(cuda, box, piece,
                                                        monkeypatch):
    """The totals and the emission (K 384 and 5, count mode) bit-equal to
    their plain versions; the segment pass's counts and partners equal,
    its best keys bit-equal where the partners agree, P_tot to rtol 1e-5,
    at the default NEAR_PIECE and (``piece``) with the heavier groups cut
    into more work items. The groups include the longest, a one-live and
    an all-live group."""
    if piece:
        monkeypatch.setattr(tfr, "NEAR_PIECE", piece)
    args = [x.to(cuda) for x in _torch(*_emit_args(box))]
    keys, nn = args[0], args[1]
    n0 = tfr.segment_totals.launches
    assert torch.equal(tfr.segment_totals(keys, nn),
                       tfr.segment_totals_plain(keys, nn))
    assert tfr.segment_totals.launches == n0 + 1
    for K in (384, 5):
        n0 = tlr.sidm_emit.launches
        got = tlr.sidm_emit(*args, N, K, box=box)
        assert tlr.sidm_emit.launches == n0 + 1
        ref = tlr.sidm_emit_plain(*args, N, K, box=box)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    n0 = tlr.sidm_emit.count_launches
    got = tlr.count_neighbours(*args, N, box=box)
    assert tlr.sidm_emit.count_launches == n0 + 1
    assert torch.equal(got, tlr.sidm_emit_plain(*args, N, 0,
                                                count_mode=True, box=box))
    nargs, params = _near_args(box)
    ins = [x.to(cuda) for x in _torch(*nargs)]
    call = (*ins, 7, torch.tensor(0.05, device=cuda),
            torch.tensor(5e2, device=cuda), params, box)
    n0 = tfr.sidm_near.launches
    k = tfr.sidm_near(*call)
    assert tfr.sidm_near.launches == n0 + 1
    pl = tfr.sidm_near_plain(*call)
    assert torch.equal(k[1], pl[1])
    torch.testing.assert_close(k[0], pl[0], rtol=1e-5, atol=1e-30)
    kk, kj, pk, pj = (x.cpu().numpy() for x in (k[2], k[3], pl[2], pl[3]))
    same = kj == pj
    np.testing.assert_array_equal(kk[same], pk[same])
    diff, ties = _near_ties(kk, kj, pk, pj)
    assert diff == ties, (diff, ties)
