"""The port's SIDM range walk (``fused_range.range_segments``: one launch
of ``csrc/range_walk.cu`` for every level of every group; on the CPU its
plain version ``range_walk_plain``, level by level) and the gated DSMC
tile (``list_range.sidm_gated``, ``csrc/sidm_gated.cu``), at a small size
with no JAX (the plain walk is held to JAX's ``_record_segments`` in
``test_torch_sidm_lists.py`` and ``test_torch_sidm_walk.py``).

The inputs are made from a seed with numpy: 4096 particles of a
clustered halo (a dense core, so that the deepest cells of a depth-6 tree
overflow the leaf size) and its 64-target Morton windows with radii from
the tree's cell-count seed; with a periodic box, the halo wrapped around
the box's corner. On the CPU:

* ``range_levels``' views of its one table equal the per-level tables it
  replaced;
* ``bounds.range_walk_work`` counts what the walk's levels classify and
  what it writes;
* the walk finds every particle within 0.99 of its group's pad of the
  group box (by the minimum image with the box), drops nothing at caps
  of its size (``FULL``), and with caps cut small drops on every path
  (cells past ``open_cap`` and children past the frontier width, overfull
  cells past ``big_cap``, particles past ``big_chunks``, keys past
  ``lvl_cap`` and past ``seg_cap``), which its telemetry counts;
* the gated tile's plain version on targets of 0, 1, 31, 32, 33 and K
  candidates against a brute force in numpy.

On the card (``gpu``): the one-launch walk bit-equal to the plain walk on
the same CUDA inputs (keys with their IMAX tails, counts, ovf, need,
telemetry, drops), with and without the box, at the small caps and with
every frontier id sent through the global scratch row (``shared_ids``
0 and 5), one ``far_level.range_launches`` a walk; the gated tile on the
mixed target list: counts equal, P_tot to rtol 1e-5 (another order of
the sum), partners equal except at near-ties.
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch import bounds
from sidm_tpu_torch.ops import fused_range as tfr
from sidm_tpu_torch.ops import list_range as tlr
from sidm_tpu_torch.ops.far_kernel import (S_NEED_N, S_OVF_L, S_OVF_N,
                                           far_level)
from sidm_tpu_torch.ops.fused_force import IMAX, FusedConfig, make_windows
from sidm_tpu_torch.ops.sidm import SidmParams
from sidm_tpu_torch.ops.tree import build_octree, level_offsets

torch.set_num_threads(2)

N, DEPTH, K_SEED = 4096, 6, 32
BOX = 1.0
# caps large enough that the walk of the halo drops nothing, and small
# enough that it drops on every path
FULL = dict(cfg=FusedConfig(big_cap=64, big_chunks=256), seg_cap=1024)
TINY = dict(cfg=FusedConfig(w_max=64, open_cap=6, big_cap=2, big_chunks=2),
            seg_cap=48, lvl_cap=10)


def _particles(box: float):
    """The halo; in the periodic box wrapped around its corner, so that
    its core straddles the box's faces."""
    rng = np.random.default_rng(31 if box else 30)
    r = 0.05 * rng.random(N) ** 2 / (1.0 - 0.9 * rng.random(N))
    v = rng.normal(size=(N, 3))
    pos = r[:, None] * v / np.linalg.norm(v, axis=1, keepdims=True)
    if box:
        pos = np.mod(pos, box)
    return torch.tensor(pos, dtype=torch.float32)


def _walk_inputs(box: float = 0.0, dev="cpu"):
    """The range walk's inputs on ``dev``: (tree, rows, glo, ghi, pad)."""
    pos = _particles(box).to(dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    mass = torch.full((N,), 1.0 / N, device=dev)
    tree = build_octree(pos, mass, torch.full_like(mass, 1e-3), valid,
                        box=box, depth=DEPTH)
    h = tfr.cell_count_hsml_seed(tree, K_SEED)[tree.perm]
    pidx, gvalid = make_windows(tree.keys_s, valid[tree.perm], N, DEPTH)
    typ = torch.ones(N, dtype=torch.int32, device=dev)
    _, _, _, _, glo, ghi, gmax = tfr.group_targets(tree, pidx, gvalid, h,
                                                   typ, box=box)
    return tree, tfr.range_levels(tree), glo, ghi, (gmax + tree.drift)


@pytest.fixture(scope="module", params=[0.0, BOX], ids=["open", "box"])
def walk(request):
    return request.param, _walk_inputs(request.param)


def _former_range_levels(tree):
    """The per-level tables range_levels built before its one table."""
    n, depth = tree.pos_s.shape[0], tree.depth
    offs = level_offsets(n, depth)
    out = []
    for l in range(depth + 1):
        sl = slice(offs[l], offs[l + 1])
        mac = tree.mac_rows[sl]
        child_local = tree.child_start[sl] - (offs[l + 1] if l < depth
                                              else 0)
        out.append(torch.cat([
            mac[:, 4:7], torch.zeros_like(mac[:, 7:8]), mac[:, 7:8],
            tree.node_start[sl, None].to(mac.dtype),
            torch.clamp(child_local, min=0)[:, None].to(mac.dtype),
            tree.child_count[sl, None].to(mac.dtype)], dim=1))
    return out


def test_range_levels_views_equal_former_tables(walk):
    _, (tree, rlev, *_) = walk
    former = _former_range_levels(tree)
    assert len(rlev.offs) == tree.depth + 2
    assert rlev.table.shape == (rlev.offs[-1], 8)
    for l, t in enumerate(former):
        assert rlev[l].data_ptr() == (rlev.table.data_ptr()
                                      + 4 * 8 * rlev.offs[l])
        assert torch.equal(rlev[l].view(torch.int32), t.view(torch.int32))


def test_range_walk_work_counts_levels_and_keys(walk):
    box, (tree, rlev, glo, ghi, pad) = walk
    levels, seen = [], []

    def obs(l, kw):
        levels.append(bounds.range_level_rows(kw))
        nl = torch.clamp(kw["n_live"].long(), max=kw["fids"].shape[1])
        live = [kw["fids"][g, :int(nl[g])].tolist()
                for g in range(nl.shape[0])]
        seen.append((sum(map(len, live)),
                     len({i for row in live for i in row
                          if 0 <= i < kw["nl_real"]})))
    seg_cap = 512
    keys, nn, _, _, stat = tfr.range_walk_plain(
        tree, rlev, glo, ghi, pad, seg_cap=seg_cap, box=box, on_level=obs)
    assert levels == seen and len(levels) == tree.depth - 1
    ng = glo.shape[0]
    ops, nbytes = bounds.range_walk_work(levels, ng, seg_cap)
    assert ops == bounds.RANGE_OPS * sum(c for c, _ in seen)
    assert nbytes == (bounds.RANGE_ROW_BYTES * sum(d for _, d in seen)
                      + 28 * ng + 4 * ng * seg_cap + (4 + 8 * 8) * ng)
    # the keys written are the appended ones, IMAX past each count
    live = torch.arange(seg_cap)[None, :] < nn[:, None]
    assert bool(torch.all((keys != IMAX) == live))
    assert bool(torch.all(nn <= stat[S_NEED_N]))


def test_range_walk_finds_every_particle_in_range(walk):
    """No drop at caps of the halo's size, every particle within 0.99 pad
    of its group's box covered by a key, and on the CPU range_segments is
    the plain walk."""
    box, (tree, rlev, glo, ghi, pad) = walk
    drops = {}
    keys, nn, ovf, need, stat = tfr.range_segments(
        tree, rlev, glo, ghi, pad, box=box, drops=drops, **FULL)
    assert int(ovf) == 0 and [int(v) for v in drops.values()] == [0, 0, 0]
    assert int(need) == int(nn.max()) > 0
    idx, val = tfr.segment_particles(keys, nn)
    d = tree.pos_s[None, :, :] - 0.5 * (glo + ghi)[:, None, :]
    if box:
        d = d - box * torch.round(d / box)
    gap = torch.clamp(torch.abs(d) - 0.5 * (ghi - glo)[:, None, :], min=0)
    near = torch.sqrt(torch.sum(gap * gap, -1)) <= 0.99 * pad[:, None]
    covered = torch.zeros((near.shape[0], N + 1), dtype=torch.bool)
    covered.scatter_(1, torch.where(val, idx, N), True)
    assert int(near.sum()) > 10 * glo.shape[0]
    assert bool(torch.all(covered[:, :N] | ~near))
    # the same walk level by level
    ref = tfr.range_walk_plain(tree, rlev, glo, ghi, pad, box=box, **FULL)
    for a, b in zip((keys, nn, ovf, need, stat), ref):
        assert torch.equal(a, b)


def test_range_walk_small_caps_drop_on_every_path(walk):
    box, (tree, rlev, glo, ghi, pad) = walk
    drops = {}
    _, nn, ovf, _, stat = tfr.range_walk_plain(
        tree, rlev, glo, ghi, pad, box=box, drops=drops, **TINY)
    assert all(int(drops[k]) > 0 for k in ("open", "big_over", "big_drop"))
    assert int(stat[S_OVF_N].sum()) > 0 and int(nn.max()) == TINY["seg_cap"]
    lvl = int(stat[S_OVF_L].sum()) - int(drops["open"]) - int(
        drops["big_over"])
    assert lvl > 0                       # keys past lvl_cap
    assert int(ovf) == int(stat[S_OVF_L].sum() + stat[S_OVF_N].sum())


# ------------------------------------------------------ the gated tile

NCANDS = (0, 1, 31, 32, 33, 64)     # K = 64
GATED_N, GATED_K = 2048, 64


def _gated_inputs():
    """Targets with the candidate counts NCANDS (each twice, a few IMAX
    holes), their candidates near them; rows (n, 8), cand, ncand, hs,
    dts, tid."""
    rng = np.random.default_rng(5)
    n, K = GATED_N, GATED_K
    pos = rng.uniform(0.0, 1.0, (n, 3))
    aux = np.where(rng.random(n) < 0.1, 9.0, 1.0)
    rows = np.concatenate([pos, rng.normal(0, 1, (n, 3)),
                           rng.uniform(0.5, 1.5, (n, 1)) / n,
                           aux[:, None]], axis=1).astype(np.float32)
    order = np.argsort(np.linalg.norm(pos - 0.5, axis=1))
    cand = np.full((n, K), IMAX, np.int32)
    ncand = np.zeros(n, np.int32)
    tgt = order[:2 * len(NCANDS)]
    for t, nc in zip(tgt, NCANDS + NCANDS):
        c = rng.choice(order[:400], nc, replace=False)
        c = c[c != t]
        cand[t, :c.size] = c
        if c.size > 2:
            cand[t, 1] = IMAX           # a hole inside the live prefix
        ncand[t] = c.size
    hs = np.where(np.isin(np.arange(n), tgt), 0.3, 0.0).astype(np.float32)
    dts = np.full(n, 0.01, np.float32)
    tid = np.concatenate([tgt, [-1, -1]]).astype(np.int32)
    return rows, cand, ncand, hs, dts, tid


PARAMS = SidmParams(5.0, 0, 1.0, 1.0, 0.0, 30, 2, False, 0.1, 0.0, 0.0)


def test_gated_plain_matches_brute_force():
    rows, cand, ncand, hs, dts, tid = _gated_inputs()
    t = torch.tensor(1.0)
    ptot, cnt, bestk, bestj = tlr.sidm_gated_plain(
        *(torch.tensor(x) for x in (rows, cand, ncand, hs, dts, tid)), 3, t,
        torch.tensor(PARAMS.cross_section_internal), PARAMS)
    assert set(int(ncand[i]) for i in tid if i >= 0) >= {0, 1, 31, 32, 33}
    for i in range(GATED_N):
        if i not in tid:
            assert (float(ptot[i]), int(cnt[i]), float(bestk[i]),
                    int(bestj[i])) == (0.0, 0, -np.inf, -1)
            continue
        c = cand[i, :ncand[i]]
        c = c[c != IMAX]
        d = rows[c, :3] - rows[i, :3]
        r = np.sqrt(np.sum(d * d, 1))
        ok = (r < hs[i]) & (rows[c, 7] < 8)
        assert int(cnt[i]) == int(ok.sum())
        assert (int(bestj[i]) in set(c[ok].tolist())) == bool(ok.any())
        if not ok.any():
            assert float(ptot[i]) == 0.0 and int(bestj[i]) == -1


# ------------------------------------------------------------- the card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("box", [0.0, BOX], ids=["open", "box"])
@pytest.mark.parametrize("case", ["default", "tiny", "global", "global5"])
def test_range_walk_kernel_matches_plain_walk_on_card(cuda, box, case):
    tree, rlev, glo, ghi, pad = _walk_inputs(box, cuda)
    kw = dict(TINY if case == "tiny" else FULL)
    shared = {"global": 0, "global5": 5}.get(case,
                                             tfr.RANGE_SHARED_IDS)
    drops_k, drops_p = {}, {}
    n0 = far_level.range_launches
    got = tfr.range_segments(tree, rlev, glo, ghi, pad, box=box,
                             drops=drops_k, shared_ids=shared, **kw)
    assert far_level.range_launches == n0 + 1
    ref = tfr.range_walk_plain(tree, rlev, glo, ghi, pad, box=box,
                               drops=drops_p, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)
    assert {k: int(v) for k, v in drops_k.items()} == \
        {k: int(v) for k, v in drops_p.items()}
    if case == "tiny":
        assert min(int(v) for v in drops_k.values()) > 0
    with pytest.raises(ValueError):
        tfr.range_segments(tree, rlev, glo, ghi, pad, box=box,
                           on_level=lambda l, kw: None, **kw)


@pytest.mark.gpu
def test_gated_kernel_mixed_counts_on_card(cuda):
    rows, cand, ncand, hs, dts, tid = (torch.tensor(x).to(cuda) for x in
                                       _gated_inputs())
    args = (rows, cand, ncand, hs, dts, tid, 3, torch.tensor(1.0,
                                                             device=cuda),
            torch.tensor(PARAMS.cross_section_internal, device=cuda), PARAMS)
    n0 = tlr.sidm_gated.launches
    k = tlr.sidm_gated(*args)
    assert tlr.sidm_gated.launches == n0 + 1
    p = tlr.sidm_gated_plain(*args)
    assert torch.equal(k[1], p[1])
    torch.testing.assert_close(k[0], p[0], rtol=1e-5, atol=1e-30)
    same = k[3] == p[3]
    assert torch.equal(k[2][same], p[2][same])
    gap = torch.abs(k[2] - p[2])[~same]
    assert bool(torch.all(gap <= 4 * torch.finfo(torch.float32).eps
                          * torch.clamp(torch.abs(p[2][~same]), min=1.0)))
    assert int(torch.sum(k[3] >= 0)) >= 6
