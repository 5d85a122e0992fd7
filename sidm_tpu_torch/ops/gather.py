"""Row gathers from a (M, 16) float32 table: the port of the three Pallas
gather probes that sized the cached-list engine's compact gather table
(``ListConfig.used_cap``, ``sidm_tpu/ops/list_force.py:64-68``):

* ``gather_rows`` is ``scripts/pallas_gather_probe.py:make_call`` with
  ``kernel_A``/``kernel_B``/``kernel_C`` (:40-55): ``out[..., :] =
  tbl[ids[...], :]``. The list engine builds its per-step compact table
  with it (``list_force.py:718-724``: used rows plus one zero row).
* ``gather_rowsum`` is ``scripts/gatherbench.py:pallas_gather``
  (``gather_kernel`` :65) and ``pallas_onehot`` (``onehot_kernel`` :99):
  the same gather, then the sum of each gathered row's 16 floats.

An id of ``M`` reads an appended zero row, as the compact table's dead
entries do; ids must lie in [0, M].

On a CUDA tensor each wrapper launches ``csrc/gather.cu``; on a CPU tensor
it runs its plain version (``tbl[ids]``, and its row sum). There is no
fallback between the two.

Kernel design (``csrc/gather.cu``). The TPU kernels keep the whole table in
VMEM and gather with a vector take or a one-hot matmul. On Hopper the table
(19 MB at the flagship's ``used_cap``, 4 MB at the probe's) stays in the
50 MB L2 by itself, so the kernel is a plain streaming gather: four threads
per output row, one 16-byte load each, so that a warp reads eight whole
64-byte rows and writes them contiguously. The row sum adds the four
partial sums with two warp shuffles. What bounds it on the H100: bytes
(the ids read and the rows written, 68 B per gathered row, 8 B in row-sum
mode); there is no arithmetic to speak of.
"""

from __future__ import annotations

import torch

ROW = 16   # floats per table row


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
    err = kernels_lib().gather_launch(*launch_args(
        tbl, int(M), ids, int(n), None if rowsum else out,
        out if rowsum else None))
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


gather_rows.launches = 0
gather_rowsum.launches = 0
