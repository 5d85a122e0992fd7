"""Leaf-segment pair forces of one walk level: the port of
``sidm_tpu/ops/pallas_near.py:_near_kernel`` (driven by ``near_items``,
:76).

``near_level`` takes each target group's compacted segment keys
``start*32+cnt`` and returns the softened pair force and potential
(``h = 2.8 max(eps_i, eps_j)``, raw-coordinate differencing) of the
particles ``start .. start+cnt-1`` of every key on the group's 64 targets.
A target's own segment is included: its self pair has zero force, and its
self potential is removed by the caller (potential.c:136).

Periodic mode (``pbc`` = (box, alpha, rcut), the TreePM split's short
range; ``_near_tile``'s pbc branch, sidm_tpu/ops/fused_force.py:350-420,
which JAX's periodic walk runs in XLA): the pair vector by the minimum
image, the screened force factor ``pm.short_range_fac`` and potential
``short_range_pot`` (their series below alpha r = 0.2 and 0.1), cut at
``rcut``. The self pair adds 2 alpha / sqrt(pi) m to the potential; the
caller removes it with the spline self term.

Free-space mode (``pbc`` = (0, alpha, rcut), ``PMVacuum``'s short range in
an isolated run: ``_near_tile(pbc)`` with box 0): the same, with the plain
pair vectors.

Ewald mode (``ewald``, an ``ops/ewald.EwaldTable``: ``PMGrid -1``'s
per-pair Ewald walk, ``sidm_tpu/ops/treeforce.py:eval_flat`` :391-430):
the minimum-image pair vector in the table's box, the softened pair force
and potential and the source mass times the Ewald correction, uncut. The
self pair adds psi(0) m to the potential besides the spline's -2.8 m / h;
the caller removes only the latter (JAX's ``tree_gravity`` keeps the
lattice self energy).

On a CUDA tensor it launches ``csrc/near_kernel.cu``; on a CPU tensor it
runs ``near_level_plain``. There is no fallback between the two.

Kernel design (``csrc/near_kernel.cu``, its source note has the detail).
The TPU kernel runs one grid step per (group, 16-key chunk) item over
fields that ``pack_near_fields`` has gathered and masked beforehand. On
the flagship's lists a few groups cover twenty times the mean group's
particles, so the port cuts every group into work items of about equal
covered-particle count (``work_items.py``; ``near_split`` is the split,
on the card three small kernels) and runs one 256-thread block per item:
it stages the covered particles with ``cp.async`` double buffering and
evaluates the pair math without a division (``rsqrt``, FMA, reciprocal
softenings). A second pass adds each group's item partials in item
order: no float atomics, the same result from run to run, every group
written. What bounds it on the H100: the pair math.
"""

from __future__ import annotations

import torch

from .ewald import interleaved
from .fused_force import G, IMAX, SC, count_launch, mode_prefix, near_tile
from .work_items import item_buffers, kernel_split, near_split_plain

ITEM_BLOCK = 256   # plain version: (group, key chunk) items per batch


def near_level_plain(keys, n_seg, pos_s, mass_s, eps_s, xr, te, *,
                     need_pot: bool, pbc=None, ewald=None):
    """Plain PyTorch version of ``near_level``: live (group, 16-key chunk)
    items in batches of ITEM_BLOCK, summed per group."""
    ng, K = keys.shape
    sc = min(SC, K)
    maxc = K // sc
    dev = pos_s.device
    acc = torch.zeros(ng, xr.shape[1], 4, dtype=pos_s.dtype, device=dev)
    nc = -(-n_seg.long() // sc)
    gi, ci = torch.nonzero(torch.arange(maxc, device=dev)[None, :]
                           < nc[:, None], as_tuple=True)
    keys_c = keys.reshape(ng, maxc, sc)
    col = torch.arange(sc, device=dev)
    for b0 in range(0, gi.shape[0], ITEM_BLOCK):
        g = gi[b0:b0 + ITEM_BLOCK]
        c = ci[b0:b0 + ITEM_BLOCK]
        # keys past a group's live count are not read (they need not be
        # IMAX)
        ent = torch.where(c[:, None] * sc + col < n_seg[g, None].long(),
                          keys_c[g, c], IMAX)
        da, dp = near_tile(ent, pos_s, mass_s, eps_s, xr[g], te[g], need_pot,
                           pbc, ewald)
        acc.index_add_(0, g, torch.cat([da, dp[..., None]], dim=-1))
    return acc


def near_level(keys, n_seg, pos_s, mass_s, eps_s, xr, te, *,
               need_pot: bool, pbc=None, ewald=None):
    """Near field of compacted segment keys for every group.

    keys (ng, K) int32 compacted keys, live prefix n_seg (ng,) int32 (the
    entries past it are not read); pos_s (N, 3), mass_s (N,), eps_s (N,)
    float32 sorted particles; xr (ng, 64, 3) raw target positions; te
    (ng, 64) target softenings; ``pbc`` (box, alpha, rcut) the periodic
    mode (box 0: the free-space mode); ``ewald`` the Ewald mode (``pbc``
    unread). Returns acc (ng, 64, 4) float32 [ax ay az pot]."""
    if ewald is not None:
        pbc = None
    if not keys.is_cuda:
        return near_level_plain(keys, n_seg, pos_s, mass_s, eps_s, xr, te,
                                need_pot=need_pot, pbc=pbc, ewald=ewald)
    from .._build import check_cuda, kernels_lib, launch_args

    ng, K = keys.shape
    n = pos_s.shape[0]
    check_cuda("near_level", keys=(keys, torch.int32, (ng, K)),
               n_seg=(n_seg, torch.int32, (ng,)),
               pos_s=(pos_s, torch.float32, (n, 3)),
               mass_s=(mass_s, torch.float32, (n,)),
               eps_s=(eps_s, torch.float32, (n,)),
               xr=(xr, torch.float32, (ng, G, 3)),
               te=(te, torch.float32, (ng, G)))
    t4 = None
    if ewald is not None:
        ed1 = ewald.en // 2 + 1
        t4 = interleaved(ewald)
        check_cuda("near_level", keys=(keys, torch.int32, (ng, K)),
                   table4=(t4, torch.float32, (ed1, ed1, ed1, 4)))
    icap, ws, part = item_buffers(ng, keys.device, near=True)
    acc = torch.empty(ng, G, 4, dtype=torch.float32, device=keys.device)
    box, alpha, rcut = (float(v) for v in pbc) if pbc else (0.0, 0.0, 0.0)
    if ewald is not None:
        box = float(ewald.box)
    mode = 2 if ewald is not None else int(pbc is not None)
    err = kernels_lib().near_level_launch(*launch_args(
        keys, n_seg, ng, K, pos_s, mass_s, eps_s, n, xr, te, int(need_pot),
        acc, ws, icap, part, box, alpha, rcut, t4,
        int(ewald.en) if ewald is not None else 0, mode))
    if err:
        raise RuntimeError(f"near_level kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(near_level, mode_prefix(pbc, ewald) + "launches")
    return acc


near_level.launches = 0
near_level.periodic_launches = 0   # launches of the periodic mode (pbc)
near_level.vacuum_launches = 0     # ... of the free-space mode (pbc, box 0)
near_level.ewald_launches = 0      # ... of the Ewald mode (ewald)


def near_split(keys, n_seg) -> dict:
    """The work items of ``near_level`` for keys (ng, K) and live counts
    n_seg (``work_items.near_split_plain``'s fields). On a CUDA tensor the
    kernel's own split (its first three launches), for checks."""
    if not keys.is_cuda:
        return near_split_plain(keys, n_seg)
    from .._build import check_cuda

    ng, K = keys.shape
    check_cuda("near_split", keys=(keys, torch.int32, (ng, K)),
               n_seg=(n_seg, torch.int32, (ng,)))
    return kernel_split("near_split_launch", True, ng, keys, n_seg, ng,
                        K)
