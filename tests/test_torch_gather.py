"""The list engine's compact node table (``sidm_tpu_torch.ops.gather``
``gather_nodes``) vs the packed node table it replaces.

``gather_nodes(tree, src)`` builds the per-step compact table straight
from the tree's ``mac_rows`` and ``quad_rows``; its plain version is
``flat_tables(pack_tree(tree))[src]`` plus the zero row, the port's former
path, with the columns no reader reads (``UNSET_COLS``: 4-7 and 15) set
to NaN. Held, on trees from the JAX package (n = 4096 Plummer and
Hernquist halos, some particles invalid; JAX's trees and packed tables
frozen in tests/data/torch_gather_golden.npz, ``python -m
tests.make_torch_golden gather``) carried across with their moments, at
the used rows of lists the port records on them:

* the port's packed table equals JAX's ``flat_tables(pack_tree(tree))``
  rows exactly in columns 0-14 (com, mass, count, node_start,
  child_start, child_count, quadrupole, eps_max) and bmax^2 (column 15)
  to float32 rounding; ``gather_nodes`` equals it in ``NODE_COLS`` (0-3
  and 8-14) and is NaN in ``UNSET_COLS``; the zero row is zero in
  ``NODE_COLS``;
* ``NODE_COLS`` are exactly ``mac_rows[:, 0:4]`` and ``quad_rows[:, 0:7]``
  of the tree: the kernel's whole function, checked here on the CPU;
* ``eval_inputs`` builds its table through ``gather_nodes`` (launches
  counted on the card only).

On the card (``gpu`` marker) the kernel is held bit-equal to the plain
version, every column, on the same tables and on random ids; and
``gather_rowsum`` (the gathered row sums, computed once per call and
gathered from shared memory or, for a table past the staging limit, from
L2) to 1e-6 of the largest sum, on aligned and unaligned ids."""

import dataclasses

import numpy as np
import pytest
import torch

from sidm_tpu_torch.ops import list_force as tlf
from sidm_tpu_torch.ops.fused_force import flat_tables, pack_tree
from sidm_tpu_torch.ops.gather import (NODE_COLS, UNSET_COLS, gather_nodes,
                                       gather_nodes_plain, gather_rowsum,
                                       gather_rowsum_plain)
from sidm_tpu_torch.ops.tree import build_octree
from tests.make_torch_golden import (GATHER, GATHER_GOLDEN, GATHER_MODELS,
                                     gather_inputs)

torch.set_num_threads(2)

N = GATHER["n"]
MODELS = GATHER_MODELS                     # model -> depth


def _trees(model):
    """(JAX tree's arrays, the port's tree of the same particles with the
    JAX tree's moments): the integer structure is the same exactly
    (tests/test_torch_tree.py), so both packed tables describe one tree."""
    pos, m, eps, valid = gather_inputs(model)
    with np.load(GATHER_GOLDEN) as z:
        jt = {k[len(model) + 2:]: z[k] for k in z.files
              if k.startswith(f"g{model}_")}
    tt = build_octree(torch.tensor(pos), torch.tensor(m), torch.tensor(eps),
                      torch.tensor(valid), depth=MODELS[model])
    assert torch.equal(tt.child_start, torch.tensor(jt["child_start"]))
    tt = dataclasses.replace(tt, mac_rows=torch.tensor(jt["mac_rows"]),
                             quad_rows=torch.tensor(jt["quad_rows"]))
    return jt, tt, valid


@pytest.fixture(scope="module", params=list(MODELS))
def case(request):
    """The trees and the used rows of the port's lists at a skin, with the
    zero row's id M appended (as ``eval_inputs`` gathers them)."""
    jt, tt, valid = _trees(request.param)
    lists = tlf.record_lists(tt, torch.zeros(N), torch.tensor(valid)[tt.perm],
                             theta=0.5, use_relative=False, skin=0.05)
    M = tt.mac_rows.shape[0]
    src = torch.cat([lists.src, torch.tensor([M], dtype=torch.int32)])
    assert int(lists.need[2]) > 100          # used rows recorded
    return dict(jt=jt, tt=tt, src=src, lists=lists, M=M)


def test_gather_nodes_plain_matches_jax_table(case):
    """The port's packed table and the plain version against JAX's
    packed table at the used rows."""
    jtbl = np.concatenate([case["jt"]["flat"],
                           np.zeros((1, 16), np.float32)])
    src = case["src"].numpy()
    ref = jtbl[src]
    full = flat_tables(pack_tree(case["tt"])).numpy()
    full = np.concatenate([full, np.zeros((1, 16), np.float32)])[src]
    np.testing.assert_array_equal(full[:, :15], ref[:, :15])
    np.testing.assert_allclose(full[:, 15], ref[:, 15], rtol=2e-6,
                               atol=1e-12)
    out = gather_nodes(case["tt"], case["src"]).numpy()
    np.testing.assert_array_equal(out[:, NODE_COLS], ref[:, NODE_COLS])
    assert np.all(np.isnan(out[:, UNSET_COLS]))
    assert np.all(out[-1, NODE_COLS] == 0)
    assert np.all(out[:-1, 3] > 0)            # used rows are live nodes


def test_node_columns_are_the_tree_arrays(case):
    """What the kernel writes, modelled on the CPU: NODE_COLS of the
    packed rows are mac_rows[:, 0:4] and quad_rows[:, 0:7], and id M reads
    zeros."""
    tt, src, M = case["tt"], case["src"], case["M"]
    out = gather_nodes_plain(tt, src)[:, NODE_COLS]
    ids = src.long()
    mac = torch.cat([tt.mac_rows, torch.zeros(1, 8)])[ids]
    quad = torch.cat([tt.quad_rows, torch.zeros(1, 8)])[ids]
    assert torch.equal(out, torch.cat([mac[:, 0:4], quad[:, 0:7]], dim=1))
    assert int(src[-1]) == M


def test_eval_inputs_uses_gather_nodes(case, monkeypatch):
    """``eval_inputs``'s table is ``gather_nodes`` of the tree at the
    lists' used rows and the zero row."""
    seen = []

    def spy(tree, ids):
        seen.append(ids)
        return gather_nodes(tree, ids)

    monkeypatch.setattr(tlf, "gather_nodes", spy)
    ctbl = tlf.eval_inputs(case["tt"], case["lists"])[0]
    assert len(seen) == 1 and torch.equal(seen[0], case["src"])
    full = flat_tables(pack_tree(case["tt"]))
    assert torch.equal(ctbl[:-1, NODE_COLS],
                       full[case["src"][:-1].long()][:, NODE_COLS])
    assert bool(torch.isnan(ctbl[:, UNSET_COLS]).all())


# ---- on the card ------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tree_to(tt, dev):
    return dataclasses.replace(tt, **{
        f.name: getattr(tt, f.name).to(dev) for f in dataclasses.fields(tt)
        if isinstance(getattr(tt, f.name), torch.Tensor)})


@pytest.mark.gpu
def test_gather_nodes_kernel_matches_plain_on_card(case, cuda):
    tt = _tree_to(case["tt"], cuda)
    g = torch.Generator(device="cpu").manual_seed(5)
    rand = torch.randint(0, case["M"] + 1, (70001,), generator=g,
                         dtype=torch.int32)
    for ids in (case["src"], rand):
        ids = ids.to(cuda)
        n0 = gather_nodes.launches
        k = gather_nodes(tt, ids)
        assert gather_nodes.launches == n0 + 1
        p = gather_nodes_plain(tt, ids)
        assert torch.equal(k.view(torch.int32), p.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("logm", [10, 14, 17])
def test_gather_rowsum_kernel_matches_plain_on_card(cuda, logm):
    """Tables of 2^10 and 2^14 rows (the probe's; staged in shared memory)
    and 2^17 (read from L2); 1M + 3 ids, also through a view one element
    in (no 16-byte loads); id M gives 0."""
    g = torch.Generator(device="cpu").manual_seed(logm)
    tbl = torch.randn(1 << logm, 16, generator=g).to(cuda)
    ids = torch.randint(0, (1 << logm) + 1, ((1 << 20) + 4,), generator=g,
                        dtype=torch.int32).to(cuda)
    for view in (ids[:-1], ids[1:]):
        n0 = gather_rowsum.launches
        k = gather_rowsum(tbl, view)
        assert gather_rowsum.launches == n0 + 1
        p = gather_rowsum_plain(tbl, view)
        assert float(torch.max(torch.abs(k - p))) <= 1e-6 * float(
            torch.max(torch.abs(p)))
        assert bool(torch.all(k[view == (1 << logm)] == 0))
