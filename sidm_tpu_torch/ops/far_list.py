"""Far field of recorded (node, target-group) pairs: the far pass of the
cached interaction lists (``sidm_tpu/ops/list_force.py:_eval`` :604-654,
the gather form :626-641 through ``_far_tile``), and the port of the
Pallas prototype of that pass, ``scripts/pallasfar.py:far_pallas_chunk``
(:135) -> ``far_kernel`` (:57).

``far_list`` takes a compact node table (U+1, 16) in the ``pack_tree`` row
layout (the last row zero), each group's far list of table row ids (ng, LF)
with live counts nf, the group-centred targets (ng, 64, 3), their
softenings (ng, 64) and the group centres (ng, 3), and returns the
group-centred monopole + Newtonian-range quadrupole ``[ax ay az pot]``
(ng, 64, 4) of every listed node on every target: the math of
``fused_force.far_tile``. ``far_units`` answers the prototype's own
interface (32-pair units of raw rows against one 64-target row each) with
the same kernel; ``k3_reference`` is that script's ``xla_ref`` in PyTorch.

Periodic mode (``pbc`` = (box, alpha, rcut) with the table's raw
quadrupole traces ``trq``, the walk's far field in a TreePM box:
``sidm_tpu/ops/fused_force.py:_far_tile_pbc`` :488-578, which JAX's
periodic walk runs in XLA): ``xc`` holds the raw target positions and
``gc`` is not read; each pair vector is the minimum image of node COM
minus target, and the pair takes the screened monopole cut at ``rcut``,
the exact screened quadrupole and the screened potential
(``fused_force.far_tile_pbc``).

Free-space mode (``pbc`` = (0, alpha, rcut), ``PMVacuum``'s short range in
an isolated run: ``_far_tile_pbc`` with box 0): the same, with the plain
pair vectors (no minimum image).

Ewald mode (``ewald``, an ``ops/ewald.EwaldTable``, with the rows'
``trq``: ``PMGrid -1``'s per-pair Ewald walk,
``sidm_tpu/ops/treeforce.py:eval_flat`` :337-375): ``xc`` holds the raw
targets and ``gc`` is not read; each pair vector is the minimum image of
node COM minus target in the table's box, and the pair takes the softened
monopole and potential, the Newtonian-range quadrupole and the node mass
times the Ewald correction of that vector, uncut; the potential also the
isotropic second-order term of the node's correction
(``fused_force.far_tile_ewald``, ROADMAP.md C.21).

On a CUDA tensor ``far_list`` launches ``csrc/far_list.cu``; on a CPU
tensor it runs ``far_list_plain``. There is no fallback between the two.

Kernel design (``csrc/far_list.cu``, its source note has the detail).
The TPU prototype pads the pairs into 32-pair units, broadcasts targets
and reduces each unit with 0/1 MXU matmuls, and the list engine's XLA pass
gathers (group block, 512-entry chunk) tiles and scatters partial sums
back. Hopper blocks run in no order, so the port cuts each group's list
into work items of about equal entry count (``work_items.py``;
``far_split`` is the split, on the card one small kernel) and runs one
256-thread block per item: it gathers rows by id inside the kernel (the
compact table, 19 MB at the flagship's ``used_cap``, stays in the 50 MB
L2), drops dead entries by a warp ballot, stages the live rows
group-centred with their reciprocal softening, and evaluates monopole +
quadrupole on the difference d = c - x with ``rsqrt`` and FMA (the walk
calls it too, for each level's far field on the ids ``far_level``
accepted). A second pass adds each group's item partials in item order:
no float atomics, every group written. What bounds it on the H100: the
pair math (75 float32 operations per (target, node) pair and 25 per list
entry without the potential, ``bounds.py``).
"""

from __future__ import annotations

import torch

from .ewald import interleaved
from .fused_force import (G, count_launch, far_tile, far_tile_ewald,
                          far_tile_pbc, mode_prefix)
from .work_items import (far_items, far_split_plain, item_buffers,
                         kernel_split)

FC = 512            # plain version: list entries per (group, chunk) item
PLAIN_PAIRS = 1 << 21   # plain version: (target, entry) pairs per batch


def far_list_plain(tbl, ids, nf, xc, te, gc, *, need_pot: bool, pbc=None,
                   trq=None, ewald=None):
    """Plain PyTorch version of ``far_list``: live (group, FC-entry chunk)
    items through ``far_tile`` (``far_tile_pbc`` with ``pbc``,
    ``far_tile_ewald`` with ``ewald``) in batches, summed per group."""
    ng, LF = ids.shape
    dev, dtype = tbl.device, tbl.dtype
    acc = torch.zeros(ng, G, 4, dtype=dtype, device=dev)
    n = torch.clamp(nf.long(), max=LF)
    fc = min(FC, max(int(n.max()), 1)) if ng else 1
    maxc = -(-LF // fc)
    gi, ci = torch.nonzero(torch.arange(maxc, device=dev)[None, :]
                           < -(-n // fc)[:, None], as_tuple=True)
    nrows = tbl.shape[0]
    col = torch.arange(fc, device=dev)
    block = max(1, PLAIN_PAIRS // (G * fc))
    for b0 in range(0, gi.shape[0], block):
        g = gi[b0:b0 + block]
        cols = ci[b0:b0 + block, None] * fc + col
        idx = ids[g[:, None], torch.clamp(cols, max=LF - 1)].long()
        live = (cols < n[g, None]) & (idx >= 0) & (idx < nrows)
        rows = tbl[torch.clamp(idx, 0, nrows - 1)]
        rows = torch.where(live[..., None], rows, torch.zeros_like(rows))
        if pbc is not None or ewald is not None:
            tr = torch.where(live, trq[torch.clamp(idx, 0, nrows - 1)],
                             torch.zeros_like(rows[..., 0]))
        if ewald is not None:
            da, dp = far_tile_ewald(rows, tr, xc[g], te[g], ewald, need_pot)
        elif pbc is not None:
            da, dp = far_tile_pbc(rows, tr, xc[g], te[g], pbc, need_pot)
        else:
            da, dp = far_tile(rows, xc[g], te[g], gc[g], need_pot)
        acc.index_add_(0, g, torch.cat([da, dp[..., None]], dim=-1))
    if not need_pot:
        acc[..., 3] = 0.0
    return acc


def far_list(tbl, ids, nf, xc, te, gc, *, need_pot: bool, pbc=None,
             trq=None, ewald=None):
    """Far field of every group's recorded nodes.

    tbl (U+1, 16) float32 compact node rows (``pack_tree`` layout; ids
    outside [0, U+1) and rows of zero mass add nothing); ids (ng, LF)
    int32 row ids, live prefix nf (ng,) int32; xc (ng, 64, 3) group-centred
    targets; te (ng, 64) target softenings; gc (ng, 3) group centres.
    ``pbc`` (box, alpha, rcut) with trq (U+1,) float32 the rows' raw
    quadrupole traces: the periodic mode (box > 0) or the free-space mode
    (box 0) (xc the raw targets, gc unread). ``ewald``: the Ewald mode
    with trq the traces (xc the raw targets, gc and ``pbc`` unread).
    Returns (ng, 64, 4) float32 [ax ay az pot] (pot 0 unless need_pot)."""
    if ewald is not None:
        pbc = None
    if (pbc is not None or ewald is not None) and trq is None:
        raise ValueError("far_list: the periodic, free-space and Ewald "
                         "modes need trq")
    if not tbl.is_cuda:
        return far_list_plain(tbl, ids, nf, xc, te, gc, need_pot=need_pot,
                              pbc=pbc, trq=trq, ewald=ewald)
    from .._build import check_cuda, kernels_lib, launch_args

    ng, LF = ids.shape
    check_cuda("far_list", tbl=(tbl, torch.float32, (tbl.shape[0], 16)),
               ids=(ids, torch.int32, (ng, LF)),
               nf=(nf, torch.int32, (ng,)),
               xc=(xc, torch.float32, (ng, G, 3)),
               te=(te, torch.float32, (ng, G)),
               gc=(gc, torch.float32, (ng, 3)))
    if trq is not None:
        check_cuda("far_list", tbl=(tbl, torch.float32, (tbl.shape[0], 16)),
                   trq=(trq, torch.float32, (tbl.shape[0],)))
    t4 = None
    if ewald is not None:
        ed1 = ewald.en // 2 + 1
        t4 = interleaved(ewald)
        check_cuda("far_list", tbl=(tbl, torch.float32, (tbl.shape[0], 16)),
                   table4=(t4, torch.float32, (ed1, ed1, ed1, 4)))
    icap, ws, part = item_buffers(ng, tbl.device, near=False)
    acc = torch.empty(ng, G, 4, dtype=torch.float32, device=tbl.device)
    box, alpha, rcut = (float(v) for v in pbc) if pbc else (0.0, 0.0, 0.0)
    if ewald is not None:
        box = float(ewald.box)
    mode = 2 if ewald is not None else int(pbc is not None)
    err = kernels_lib().far_list_launch(*launch_args(
        tbl, int(tbl.shape[0]), ids, nf, ng, LF, xc, te, gc, int(need_pot),
        acc, ws, icap, part, trq, box, alpha, rcut, t4,
        int(ewald.en) if ewald is not None else 0, mode))
    if err:
        raise RuntimeError(f"far_list kernel launch failed: CUDA error {err}")
    count_launch(far_list, mode_prefix(pbc, ewald) + "launches")
    return acc


def far_split(nf, LF: int) -> dict:
    """The work items of ``far_list`` for live counts nf (ng,) under the
    cap LF (``work_items.far_split_plain``'s fields). On a CUDA tensor the
    kernel's own split (its first launch), for checks."""
    if not nf.is_cuda:
        return far_split_plain(nf, LF)
    from .._build import check_cuda

    ng = nf.shape[0]
    check_cuda("far_split", nf=(nf, torch.int32, (ng,)))
    f = kernel_split("far_split_launch", False, ng, nf, ng, LF)
    return far_items(nf, LF, f["unit"], f["off"], f["item_g"])


far_list.launches = 0
far_list.periodic_launches = 0   # launches of the periodic mode (pbc)
far_list.vacuum_launches = 0     # ... of the free-space mode (pbc, box 0)
far_list.ewald_launches = 0      # ... of the Ewald mode (ewald)


def units_to_lists(rows, tgt):
    """The prototype's units as ``far_list`` inputs (tbl, ids, nf, xc, te,
    gc): unit u is group u with rows 32u .. 32u+31; reciprocal softenings
    become softenings; targets are raw coordinates about a group centre
    of 0."""
    NU = tgt.shape[0]
    dev = rows.device
    tbl = rows.clone()
    tbl[:, 14] = 1.0 / rows[:, 14]
    ids = torch.arange(NU * 32, dtype=torch.int32,
                       device=dev).reshape(NU, 32)
    nf = torch.full((NU,), 32, dtype=torch.int32, device=dev)
    xc = torch.stack([tgt[:, 0:G], tgt[:, G:2 * G], tgt[:, 2 * G:3 * G]],
                     dim=-1).contiguous()
    te = (1.0 / tgt[:, 3 * G:4 * G]).contiguous()
    gc = torch.zeros(NU, 3, dtype=rows.dtype, device=dev)
    return tbl, ids, nf, xc, te, gc


def far_units(rows, tgt):
    """``scripts/pallasfar.py``'s interface: rows (NU*32, 16) node rows
    with slot 14 = 1/eps; tgt (NU, 256) = [tx(64) ty(64) tz(64) 1/eps(64)]
    per unit. Returns per-unit sums (a0, a1, a2, pot), each (NU, 64), as
    ``xla_ref`` does."""
    acc = far_list(*units_to_lists(rows, tgt), need_pot=True)
    return acc[..., 0], acc[..., 1], acc[..., 2], acc[..., 3]


def k3_reference(rows, tgt):
    """``scripts/pallasfar.py:xla_ref`` (:161) in PyTorch: the same
    function in the prototype's own arithmetic (rsqrt, reciprocal
    softenings, node-minus-target differences)."""
    NU = tgt.shape[0]
    com = rows[:, 0:3]
    m = rows[:, 3]
    tr = torch.repeat_interleave(tgt, 32, dim=0)
    tx, ty, tz, tie = (tr[:, 0:G], tr[:, G:2 * G], tr[:, 2 * G:3 * G],
                       tr[:, 3 * G:4 * G])
    d0 = com[:, 0:1] - tx
    d1 = com[:, 1:2] - ty
    d2 = com[:, 2:3] - tz
    r2 = d0 * d0 + d1 * d1 + d2 * d2
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-37))
    h_inv = torch.minimum(tie, rows[:, 14:15]) * (1.0 / 2.8)
    r = r2 * inv_r
    u = r * h_inv
    inv_r3 = inv_r * inv_r * inv_r
    u2 = u * u
    u3 = u2 * u
    h_inv3 = h_inv * h_inv * h_inv
    inner = 32.0 * (1.0 / 3.0 - 1.2 * u2 + u3) * h_inv3
    outer = (64.0 * (1.0 / 3.0 - 0.75 * u + 0.6 * u2 - u3 / 6.0) * h_inv3
             - inv_r3 * (1.0 / 15.0))
    wf = torch.where(u < 0.5, inner, outer)
    newton = u >= 1.0
    fac = m[:, None] * torch.where(newton, inv_r3, wf)
    a0, a1, a2 = fac * d0, fac * d1, fac * d2
    q = rows[:, 8:14]
    ir = torch.where(newton, inv_r, torch.zeros_like(inv_r))
    ir2 = ir * ir
    w5 = ir2 * ir2 * ir
    w7 = w5 * ir2
    u0 = q[:, 0:1] * d0 + q[:, 3:4] * d1 + q[:, 4:5] * d2
    u1 = q[:, 3:4] * d0 + q[:, 1:2] * d1 + q[:, 5:6] * d2
    u2_ = q[:, 4:5] * d0 + q[:, 5:6] * d1 + q[:, 2:3] * d2
    dqd = d0 * u0 + d1 * u1 + d2 * u2_
    t7 = 2.5 * w7 * dqd
    a0 = a0 - w5 * u0 + t7 * d0
    a1 = a1 - w5 * u1 + t7 * d1
    a2 = a2 - w5 * u2_ + t7 * d2
    wp_in = (16.0 / 3.0 * u2 - 9.6 * u2 * u2 + 6.4 * u2 * u3 - 2.8) * h_inv
    wp_out = inv_r * (1.0 / 15.0) + (32.0 / 3.0 * u2 - 16.0 * u3
                                     + 9.6 * u2 * u2
                                     - 32.0 / 15.0 * u2 * u3 - 3.2) * h_inv
    wp = torch.where(u < 0.5, wp_in, wp_out)
    p = m[:, None] * torch.where(newton, -inv_r, wp) - 0.5 * dqd * w5

    def red(a):
        return a.reshape(NU, 32, G).sum(1)
    return red(a0), red(a1), red(a2), red(p)
