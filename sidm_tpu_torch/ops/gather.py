"""Row gathers: the port of the three Pallas gather probes that sized the
cached-list engine's compact gather table (``ListConfig.used_cap``,
``sidm_tpu/ops/list_force.py:64-68``), and that table itself:

* ``gather_nodes`` builds the list engine's per-step compact node table
  (``list_force.py:718-724``: the used rows of ``flat_tables(pack_tree(
  tree))`` plus one zero row) straight from the tree's ``mac_rows`` and
  ``quad_rows``, without packing the 7.6 M-row table first. Its one
  reader, ``far_list`` (through ``list_force.eval_lists``), reads columns
  ``NODE_COLS``: 0-3 (com, mass) and 8-14 (quadrupole, eps_max). Those
  are bit-equal to the packed table's rows. Columns 4-7 (count,
  node_start, child_start, child_count) and 15 (bmax^2), which the far
  pass never reads, would cost three scattered loads per row and a
  recomputed bmax: on both devices they hold NaN (``UNSET_COLS``), so that
  a reader of them gets NaN on the CPU as on the card. The plain version
  is the packed table's gather with those columns set to NaN.
* ``gather_rows`` is ``scripts/pallas_gather_probe.py:make_call`` with
  ``kernel_A``/``kernel_B``/``kernel_C`` (:40-55): ``out[..., :] =
  tbl[ids[...], :]``, the probe's function at its shapes.
* ``gather_rowsum`` is ``scripts/gatherbench.py:pallas_gather``
  (``gather_kernel`` :65) and ``pallas_onehot`` (``onehot_kernel`` :99):
  the same gather, then the sum of each gathered row's 16 floats.

An id of ``M`` reads an appended zero row, as the compact table's dead
entries do; ids must lie in [0, M] (``gather_nodes``: M tree nodes).

On a CUDA tensor each wrapper launches ``csrc/gather.cu``; on a CPU tensor
it runs its plain version (``tbl[ids]``, and its row sum). There is no
fallback between the two.

Kernel design (``csrc/gather.cu``). The TPU kernels keep the whole table in
VMEM and gather with a vector take or a one-hot matmul. On Hopper the table
(19 MB at the flagship's ``used_cap``, 4 MB at the probe's) stays in the
50 MB L2 by itself, so the kernel is a plain streaming gather: four threads
per output row, one 16-byte load each, so that a warp reads eight whole
64-byte rows and writes them contiguously. The row sum (redesigned)
uses that a gathered row's sum is the gathered row sum: the M row sums are
computed once per call, and the gather then reads 4 bytes per id instead
of 64, from the sums staged in shared memory when M + 1 floats fit (48 K
floats; the probe's tables have 2^14 and 2^10 rows), else from L2. ``gather_nodes`` runs one thread
per row: three independent 16-byte loads (com and mass from the node's
32-byte ``mac_rows`` row, the quadrupole and eps from its ``quad_rows``
row) and the whole 64-byte row written. What bounds them on the H100:
bytes (the ids read, the rows read and written); there is no arithmetic
to speak of.
"""

from __future__ import annotations

import torch

from .fused_force import flat_tables, pack_tree

ROW = 16   # floats per table row
NODE_COLS = [0, 1, 2, 3, 8, 9, 10, 11, 12, 13, 14]   # gather_nodes: rows'
UNSET_COLS = [4, 5, 6, 7, 15]                        # ... and NaN


def _with_zero_row(tbl):
    return torch.cat([tbl, torch.zeros(1, ROW, dtype=tbl.dtype,
                                       device=tbl.device)])


def gather_rows_plain(tbl, ids):
    """Plain PyTorch version of ``gather_rows``."""
    return _with_zero_row(tbl)[ids.long()]


def gather_rowsum_plain(tbl, ids):
    """Plain PyTorch version of ``gather_rowsum``."""
    return gather_rows_plain(tbl, ids).sum(-1, keepdim=True)


def _launch(name, tbl, ids, rowsum: bool):
    from .._build import check_cuda, kernels_lib, launch_args

    M = tbl.shape[0]
    check_cuda(name, tbl=(tbl, torch.float32, (M, ROW)),
               ids=(ids, torch.int32, tuple(ids.shape)))
    n = ids.numel()
    out = torch.empty(*ids.shape, 1 if rowsum else ROW, dtype=torch.float32,
                      device=tbl.device)
    if rowsum:
        sums = torch.empty(M + 1, dtype=torch.float32, device=tbl.device)
        err = kernels_lib().rowsum_launch(*launch_args(
            tbl, int(M), ids, int(n), sums, out))
    else:
        err = kernels_lib().gather_launch(*launch_args(
            tbl, int(M), ids, int(n), out))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def gather_rows(tbl, ids):
    """tbl (M, 16) float32, ids int32 of any shape with values in [0, M].
    Returns (*ids.shape, 16): row ``ids[i]`` of tbl, zeros for id M."""
    if not tbl.is_cuda:
        return gather_rows_plain(tbl, ids)
    out = _launch("gather_rows", tbl, ids, rowsum=False)
    gather_rows.launches += 1
    return out


def gather_rowsum(tbl, ids):
    """tbl (M, 16) float32, ids int32 of any shape with values in [0, M].
    Returns (*ids.shape, 1): the sum of row ``ids[i]``, 0 for id M."""
    if not tbl.is_cuda:
        return gather_rowsum_plain(tbl, ids)
    out = _launch("gather_rowsum", tbl, ids, rowsum=True)
    gather_rowsum.launches += 1
    return out


def gather_nodes_plain(tree, ids):
    """Plain PyTorch version of ``gather_nodes``: the packed all-level
    table's rows, columns UNSET_COLS set to NaN."""
    out = gather_rows_plain(flat_tables(pack_tree(tree)), ids)
    out[:, UNSET_COLS] = float("nan")
    return out


def gather_nodes(tree, ids):
    """Compact node table rows of the ``Octree`` ``tree``: ids (n,) int32
    flat node ids in [0, M] (M = tree nodes; M gives a zero row). Returns
    (n, 16) float32 in the ``pack_tree`` row layout, columns UNSET_COLS
    NaN (see the module note)."""
    if not ids.is_cuda:
        return gather_nodes_plain(tree, ids)
    from .._build import check_cuda, kernels_lib, launch_args

    M = tree.mac_rows.shape[0]
    n = ids.numel()
    check_cuda("gather_nodes", mac=(tree.mac_rows, torch.float32, (M, 8)),
               quad=(tree.quad_rows, torch.float32, (M, 8)),
               ids=(ids, torch.int32, (n,)))
    out = torch.empty(n, ROW, dtype=torch.float32, device=ids.device)
    err = kernels_lib().node_rows_launch(*launch_args(
        tree.mac_rows, tree.quad_rows, int(M), ids, int(n), out))
    if err:
        raise RuntimeError(f"gather_nodes kernel launch failed: CUDA error "
                           f"{err}")
    gather_nodes.launches += 1
    return out


gather_nodes.launches = 0
gather_rows.launches = 0
gather_rowsum.launches = 0
