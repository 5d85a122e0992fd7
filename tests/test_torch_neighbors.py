"""The port's hash grid (``sidm_tpu_torch/ops/neighbors.py``) against the
JAX package's ``sidm_tpu/ops/neighbors.py`` on ``hash_inputs`` (an NFW halo
of 4000 particles, 50 of them type 2, padded to 4096 with type -1; open and
wrapped into a periodic box), with JAX's outputs frozen in
tests/data/torch_hash_golden.npz (``python -m tests.make_torch_golden
hash``; the ``slow`` test reruns them):

* ``build_table`` bit-equal: ``sorted_part``, every non-empty bucket's
  start and count, and no other bucket holding an entry;
* ``level_for_radius`` (the port's exact rule, the smallest l with
  s0 2^l >= h) equal to JAX's ceil(log2(h / s0)) on random radii;
* ``gather_candidates`` at cap 8 (JAX's fixed cap, which truncates most
  buckets here): ids, masks and overflow flags equal, so the port drops
  exactly JAX's candidates;
* ``knn_radius`` at caps 96 and 8 and ``setup_smoothing_lengths``: h to
  1e-6 relative (the squared distances' three-term sums may round one ULP
  apart: JAX's XLA reduction has its own order), counts and overflow flags
  equal;
* the compact layout of the port's engines (``candidate_blocks``) holds
  the dense layout's candidates in the same order, and ``need``/``clip``
  count what JAX drops silently.

On the card (``gpu``): H1 (``csrc/hash_knn.cu``) bit-equal to the plain
version.
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.ops import neighbors as tn
from sidm_tpu_torch.state import make_particles
from tests.make_torch_golden import (HASH, HASH_GOLDEN, hash_inputs,
                                     hash_radii, jax_hash_ops)

torch.set_num_threads(2)

TAGS = {"o": 0.0, "b": HASH["box"]}


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(HASH_GOLDEN))


def _table(tag, device="cpu"):
    pos, ptype = hash_inputs(TAGS[tag])
    pos_t = torch.tensor(pos, device=device)
    ptype_t = torch.tensor(ptype, device=device)
    valid = ptype_t >= 0
    s0 = tn.default_cell_size(pos_t, valid, HASH["k"], TAGS[tag])
    table = tn.build_table(pos_t, ptype_t, valid, s0=s0, box=TAGS[tag],
                           n_levels=HASH["levels"])
    return table, pos_t, ptype_t, s0


@pytest.mark.parametrize("tag", list(TAGS))
def test_build_table_bit_equal(golden, tag):
    table, pos, ptype, s0 = _table(tag)
    assert s0 == float(golden[f"{tag}_s0"])
    np.testing.assert_array_equal(table.sorted_part.numpy(),
                                  golden[f"{tag}_sorted_part"])
    cnt = table.bucket_count.numpy()
    nz = np.nonzero(cnt)[0]
    np.testing.assert_array_equal(nz, golden[f"{tag}_nzkey"])
    np.testing.assert_array_equal(cnt[nz], golden[f"{tag}_nzcount"])
    np.testing.assert_array_equal(table.bucket_start.numpy()[nz],
                                  golden[f"{tag}_nzstart"])
    # the payload rows are the particles' rows in sorted order
    want = tn.make_payload(pos, torch.zeros_like(pos),
                           torch.zeros(pos.shape[0]), ptype)
    assert torch.equal(table.rows, want[table.sorted_part.long()])


@pytest.mark.parametrize("tag", list(TAGS))
def test_levels_equal_jax(golden, tag):
    table = _table(tag)[0]
    h = torch.tensor(hash_radii(HASH["npad"]))
    lev, clip = tn.level_for_radius(table, h)
    np.testing.assert_array_equal(lev.numpy(), golden[f"{tag}_lev"])
    assert bool(torch.all(clip == (h > table.s0 * 2.0 ** (HASH["levels"]
                                                          - 1))))
    # a radius exactly on a level's size takes that level
    lev2, _ = tn.level_for_radius(table, table.s0 * torch.tensor([1.0, 4.0]))
    assert lev2.tolist() == [0, 2]


@pytest.mark.parametrize("tag", list(TAGS))
def test_gather_candidates_small_cap_equal_jax(golden, tag):
    table, pos, ptype, _ = _table(tag)
    h = torch.tensor(hash_radii(HASH["npad"]))
    sel = np.linspace(0, HASH["npad"] - 1, HASH["subset"]).astype(np.int64)
    idx, rows, mask, ovf = tn.gather_candidates(
        table, pos[sel], ptype[sel], h[sel] / 20.0, cap=HASH["small_cap"])
    gmask = golden[f"{tag}_gmask"]
    np.testing.assert_array_equal(mask.numpy(), gmask)
    np.testing.assert_array_equal(idx.numpy()[gmask],
                                  golden[f"{tag}_gidx"][gmask])
    np.testing.assert_array_equal(ovf.numpy(), golden[f"{tag}_govf"])
    assert 0 < int(ovf.sum()) < ovf.numel()


def _close(a, b, rtol=1e-6):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


@pytest.mark.parametrize("ctag,cap", [("k", 96), ("k8", 8)])
@pytest.mark.parametrize("tag", list(TAGS))
def test_knn_radius_equal_jax(golden, tag, ctag, cap):
    table, pos, ptype, s0 = _table(tag)
    h0 = torch.full((HASH["npad"],), 2.0 * s0)
    r = tn.knn_radius(table, pos, ptype, h0, HASH["k"], cap=cap, n_iter=3)
    valid = ptype.numpy() >= 0
    err = _close(r.h.numpy()[valid], golden[f"{tag}_{ctag}h"][valid])
    print(f"{tag} cap {cap}: h rel err {err:.3e}, buckets past cap "
          f"{int((r.need > cap).sum())}, clipped {int(r.clip.sum())}")
    assert err <= 1e-6
    np.testing.assert_array_equal(r.cnt.numpy()[valid],
                                  golden[f"{tag}_{ctag}cnt"][valid])
    np.testing.assert_array_equal(r.ovf.numpy(), golden[f"{tag}_{ctag}ovf"])
    assert bool(torch.all(r.need[r.ovf] > cap))


@pytest.mark.parametrize("tag", list(TAGS))
def test_setup_smoothing_lengths_equal_jax(golden, tag):
    pos, ptype = hash_inputs(TAGS[tag])
    n = HASH["n"]
    p = make_particles(pos[:n], np.zeros((n, 3)), np.ones(n), ptype[:n],
                       pad_to_multiple=HASH["npad"])
    q = tn.setup_smoothing_lengths(p, HASH["k"], 2,
                                   box=TAGS[tag] if TAGS[tag] else None)
    assert _close(q.hsml_vd.numpy()[:n], golden[f"{tag}_sh"][:n]) <= 1e-6
    np.testing.assert_array_equal(q.ngb_vd.numpy(), golden[f"{tag}_sn"])


@pytest.mark.parametrize("tag", list(TAGS))
def test_compact_layout_holds_dense_candidates(tag):
    """candidate_blocks (the engines' layout) gives each query the dense
    layout's masked candidates in the same order, need = the largest
    deduplicated bucket count and the rows read."""
    table, pos, ptype, _ = _table(tag)
    h = torch.tensor(hash_radii(HASH["npad"])) / 10.0
    sel = torch.arange(0, HASH["npad"], 7)
    cap = 12
    blocks, need, clip, tot = tn.candidate_blocks(
        table, pos[sel], ptype[sel], h[sel], cap=cap, budget=4096)
    blocks = list(blocks)
    assert len(blocks) > 1
    idx, _, mask, ovf = tn.gather_candidates(table, pos[sel], ptype[sel],
                                             h[sel], cap=cap)
    seen = torch.zeros(sel.numel(), dtype=torch.int64)
    for b in blocks:
        for r, q in enumerate(b.sel.tolist()):
            got = table.sorted_part[b.entry[r][b.mask[r]]]
            assert torch.equal(got, idx[q][mask[q]])
            seen[q] += 1
    assert bool(torch.all(seen == 1))
    assert torch.equal(ovf, need > cap)
    lev, cl = tn.level_for_radius(table, h[sel])
    assert torch.equal(clip, cl)
    key, dup, _ = tn.stencil(table, pos[sel], ptype[sel], h[sel])
    cnt = torch.where(dup, 0, table.bucket_count[key].long())
    assert torch.equal(tot, torch.sum(torch.clamp(cnt, max=cap), 1))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [8, 96, 4096])
@pytest.mark.parametrize("tag", list(TAGS))
def test_knn_kernel_bit_equal_plain_on_card(cuda, tag, cap):
    table, pos, ptype, s0 = _table(tag, cuda)
    h0 = torch.full((HASH["npad"],), 2.0 * s0, device=cuda)
    n0 = tn.knn_radius.launches
    k = tn.knn_radius(table, pos, ptype, h0, HASH["k"], cap=cap, n_iter=4)
    assert tn.knn_radius.launches == n0 + 1
    p = tn.knn_radius_plain(table, pos, ptype, h0, HASH["k"], cap=cap,
                            n_iter=4)
    for f in ("h", "cnt", "ovf", "need", "clip", "scanned"):
        assert torch.equal(getattr(k, f), getattr(p, f).to(
            getattr(k, f).dtype)), f


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """This file's part of the committed golden file is what the JAX
    package gives now."""
    live = jax_hash_ops()
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
