"""Octree of the PyTorch port vs the JAX package (build and refresh).

Integer structure is held exactly: Morton keys, the sort permutation,
per-level node_start/node_count/child_start/child_count and node counts.
Mass, COM, quadrupole and bmax are held against float64 moments of the same
particles: the port sums in float64 and rounds once, so it must agree with
them to rtol 1e-5 of the quantity's natural scale (the cube extent for
COM, the node's raw second moment m (|com|^2 + size^2) for the quadrupole,
the node size for bmax). The JAX package sums in float32 with blocked
prefix sums, whose error is its own: on these inputs up to 1e-4 (Plummer)
and 5.6e-2 (Hernquist) of a node's raw second moment, so no float32 sum in
another order could be held to it at rtol 1e-5. The port must agree with
it to within that error plus the same rtol 1e-5.

JAX's outputs are frozen in tests/data/torch_tree_golden.npz (``python -m
tests.make_torch_golden tree``)."""

import types

import numpy as np
import pytest
import torch

from sidm_tpu_torch.ops import fused_force as tff
from sidm_tpu_torch.ops import morton as tmorton
from sidm_tpu_torch.ops.tree import build_octree as tbuild
from sidm_tpu_torch.ops.tree import refresh_octree as trefresh
from tests.make_torch_golden import (PACKED_COLS, TREE_FIELDS, TREE_GOLDEN,
                                     compact_keys, tree_inputs)

torch.set_num_threads(2)

RTOL = 1e-5
INT_FIELDS = ("perm", "keys_s", "node_start", "node_count", "child_start",
              "child_count")
_inputs = tree_inputs


@pytest.fixture(scope="module")
def golden():
    with np.load(TREE_GOLDEN) as z:
        return {k: z[k] for k in z.files}


def jax_tree(golden, prefix):
    """The frozen JAX tree ``prefix``: its fields, and ``packed``, its
    pack_tree levels' PACKED_COLS columns, one array a level."""
    jt = types.SimpleNamespace(**{f: golden[prefix + f]
                                  for f in TREE_FIELDS})
    ends = np.cumsum(golden[prefix + "packed_sizes"])
    jt.packed = np.split(golden[prefix + "packed"], ends[:-1])
    return jt


def _port(fn, *arrays, **kw):
    return fn(*(torch.tensor(a) for a in arrays), **kw)


def _exact_moments(jt):
    """float64 mass, COM and traceless quadrupole of every node, from the
    JAX tree's sorted particles and node ranges."""
    x = np.asarray(jt.pos_s, np.float64)
    m = np.asarray(jt.mass_s, np.float64)
    prods = np.stack([m, m * x[:, 0], m * x[:, 1], m * x[:, 2],
                      m * x[:, 0] ** 2, m * x[:, 1] ** 2, m * x[:, 2] ** 2,
                      m * x[:, 0] * x[:, 1], m * x[:, 0] * x[:, 2],
                      m * x[:, 1] * x[:, 2]], axis=1)
    c = np.concatenate([np.zeros((1, 10)), np.cumsum(prods, axis=0)])
    a = np.asarray(jt.node_start).astype(np.int64)
    s = c[a + np.asarray(jt.node_count)] - c[a]
    sm = s[:, 0]
    com = s[:, 1:4] / np.maximum(sm, 1e-300)[:, None]
    sec = [s[:, 4 + k] - sm * com[:, i] * com[:, j] for k, (i, j) in
           enumerate([(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)])]
    tr = sec[0] + sec[1] + sec[2]
    quad = np.stack([3 * sec[0] - tr, 3 * sec[1] - tr, 3 * sec[2] - tr,
                     3 * sec[3], 3 * sec[4], 3 * sec[5]], axis=1)
    return sm, com, quad


def _within(port, jax_v, exact, scale):
    """Port within RTOL*scale of exact, and within JAX's own error of JAX."""
    scale = np.broadcast_to(scale, exact.shape)
    assert np.all(np.abs(port - exact) <= RTOL * scale)
    assert np.all(np.abs(port - jax_v) <= np.abs(jax_v - exact)
                  + RTOL * scale)


def _compare_trees(jt, tt):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(jt, f)).astype(np.int64),
            getattr(tt, f).numpy().astype(np.int64), err_msg=f)
    assert [int(x) for x in jt.n_nodes] == tt.n_nodes
    assert tuple(jt.level_offsets) == tt.level_offsets
    np.testing.assert_array_equal(np.asarray(jt.origin), tt.origin.numpy())
    assert float(jt.extent) == float(tt.extent)
    np.testing.assert_allclose(float(tt.drift), float(jt.drift), rtol=RTOL)

    jm, tm = np.asarray(jt.mac_rows), tt.mac_rows.numpy()
    jq, tq = np.asarray(jt.quad_rows), tt.quad_rows.numpy()
    live = np.asarray(jt.node_count) > 0
    # geometric centre, count, eps_max and size: same arithmetic, exact
    np.testing.assert_array_equal(jm[:, 4:8], tm[:, 4:8])
    np.testing.assert_array_equal(jq[:, 6:8], tq[:, 6:8])
    sm, com, quad = (v[live] for v in _exact_moments(jt))
    ext = float(jt.extent)
    _within(tm[live, 3], jm[live, 3], sm, sm)
    _within(tm[live, :3], jm[live, :3], com, ext)
    size = jq[live, 7:8]
    _within(tq[live, :6], jq[live, :6], quad,
            sm[:, None] * (np.sum(com ** 2, axis=1, keepdims=True)
                           + size ** 2))
    # bmax = |com - centre| + (sqrt 3 / 2) size + drift, as packed for the
    # walk: its error is the COM error
    assert PACKED_COLS == [4, 5, 6, 7, 15]
    packed = tff.pack_tree(tt).levels
    assert len(packed) == len(jt.packed)
    for l, (a, b) in enumerate(zip(jt.packed, packed)):
        b = b.numpy()
        np.testing.assert_array_equal(a[:, 0:4], b[:, 4:8])
        lv = a[:, 0] > 0
        np.testing.assert_allclose(np.sqrt(b[lv, 15]), np.sqrt(a[lv, 4]),
                                   rtol=RTOL, atol=RTOL * ext)


@pytest.mark.parametrize("model,depth", [("plummer", 8), ("hernquist", 11)])
def test_morton_keys_exact(golden, model, depth):
    pos, _, _, valid = _inputs(model, 4096, 1, 100)
    to, te = tmorton.bounding_cube(torch.tensor(pos), torch.tensor(valid))
    np.testing.assert_array_equal(golden[f"m{model}_origin"], to.numpy())
    assert float(golden[f"m{model}_extent"]) == float(te)
    th, tl = tmorton.morton_keys2(torch.tensor(pos), to, te, depth)
    np.testing.assert_array_equal(
        golden[f"m{model}_hi"].astype(np.int64), th.numpy())
    np.testing.assert_array_equal(
        golden[f"m{model}_lo"].astype(np.int64), tl.numpy())


@pytest.mark.parametrize("uniform_eps", [False, True])
@pytest.mark.parametrize("model,depth", [("plummer", 8), ("hernquist", 11)])
def test_build_octree_matches(golden, model, depth, uniform_eps):
    pos, m, eps, valid = _inputs(model, 4096, 2, 97)
    if uniform_eps:
        eps = np.full_like(eps, 0.05)
    tt = _port(tbuild, pos, m, eps, valid, depth=depth,
               uniform_eps=uniform_eps)
    _compare_trees(jax_tree(golden, f"b{model}{int(uniform_eps)}_"), tt)


@pytest.mark.parametrize("model,depth", [("plummer", 8), ("hernquist", 11)])
def test_refresh_octree_matches(golden, model, depth):
    pos, m, eps, valid = _inputs(model, 4096, 3, 50)
    tt = _port(tbuild, pos, m, eps, valid, depth=depth)
    rng = np.random.default_rng(4)
    for _ in range(2):   # two refreshes accumulate drift
        pos = (pos + rng.normal(size=pos.shape) * 0.02).astype(np.float32)
        tt = trefresh(tt, torch.tensor(pos), torch.tensor(m),
                      torch.tensor(eps), torch.tensor(valid))
    assert float(tt.drift) > 0
    _compare_trees(jax_tree(golden, f"r{model}_"), tt)


def test_make_windows_exact(golden):
    pos, m, eps, valid = _inputs("plummer", 4096, 5, 60)
    tt = _port(tbuild, pos, m, eps, valid, depth=8)
    vs = valid[tt.perm.numpy()]
    tp, tv = tff.make_windows(tt.keys_s, torch.tensor(vs), 4096, 8)
    np.testing.assert_array_equal(golden["w_pidx"], tp.numpy())
    np.testing.assert_array_equal(golden["w_gvalid"], tv.numpy())


def test_compact_plane_exact(golden):
    keys = compact_keys()
    b, cnt = tff.compact_plane(torch.tensor(keys))
    np.testing.assert_array_equal(golden["c_out"], b.numpy())
    np.testing.assert_array_equal(cnt.numpy(), (keys != tff.IMAX).sum(1))
