"""One walk level's classify + far multipole + key emission: the port of
``sidm_tpu/ops/pallas_far.py:_far_kernel`` (driven by ``far_items``, :194).

``far_level`` takes one level's frontier for every target group and
returns the group's far-field ``[ax ay az pot]`` from the nodes it accepts,
plus three int32 key planes in frontier order: segment keys
``nstart*32+min(cnt,31)`` for opened leaves, open keys ``cstart*16+ccnt``
for opened inner cells, and (last level only) big keys = node id for
overfull deepest cells.

``record=True`` is the cached-list engine's recording walk
(``sidm_tpu/ops/list_force.py:_walk_level_keys`` :160-217): the far-field
math is skipped, and a fourth key plane holds the flat node id
``lvl_base + local id`` of every accepted node, in frontier order. The
classification is the same, so all key planes equal the plain version's.

On a CUDA tensor it launches ``csrc/far_kernel.cu``; on a CPU tensor it runs
``far_level_plain``, the same function in plain PyTorch. There is no
fallback between the two.

Kernel design (``csrc/far_kernel.cu``). The TPU kernel runs one grid step
per (group, 128-node chunk) item and relies on the sequential grid to
revisit-accumulate a group's output block. Hopper blocks run in no order,
so the port runs ONE thread block per target group that loops over the
group's whole frontier in 128-node chunks: the accumulators stay in
registers, nothing is atomic, the result is deterministic and every group's
output is written (groups with no frontier get zeros). Each chunk's rows are
gathered straight from the level table by frontier id (the TPU path
materialises them with ``pack_rows_t``; at N = 1e6 that tensor would be
gigabytes), classified one node per thread, keys written in frontier order,
and the accepted nodes compacted into shared memory, over which 2 threads
per target split the pair math. Classification is compiled without FMA
contraction so that it rounds exactly like the plain version and the keys
match bit for bit. What bounds it on the H100: the per-pair far math
(~90 float32 operations per (target, node) pair) at 128 threads per block;
the node-row gathers are 64 B each and cached.
"""

from __future__ import annotations

import torch

from .fused_force import (G, IMAX, R_CCNT, R_CNT, R_CSTART, R_MASS,
                          R_NSTART, WC, classify, far_tile)

ITEM_BLOCK = 512   # plain version: (group, chunk) items per batch


def far_level_plain(fids, n_live, tbl, nl_real: int, s_l, xc, te, glo, ghi,
                    oac, *, theta2: float, use_relative: bool,
                    leaf_cap: int, last: bool, need_pot: bool,
                    record: bool = False, lvl_base: int = 0):
    """Plain PyTorch version of ``far_level``: live (group, chunk) items
    are evaluated in batches of ITEM_BLOCK (bounding the (B, G, WC)
    intermediates) and summed per group."""
    ng, W = fids.shape
    wc = min(WC, W)
    maxc = W // wc
    dev, dtype = tbl.device, tbl.dtype
    acc = None if record else torch.zeros(ng, G, 4, dtype=dtype, device=dev)
    keys = torch.full((4, ng, maxc, wc), IMAX, dtype=torch.int32, device=dev)
    nc = -(-torch.clamp(n_live.long(), max=W) // wc)
    gi, ci = torch.nonzero(torch.arange(maxc, device=dev)[None, :]
                           < nc[:, None], as_tuple=True)
    fids_c = fids.reshape(ng, maxc, wc)
    gc = 0.5 * (glo + ghi)
    for b0 in range(0, gi.shape[0], ITEM_BLOCK):
        g = gi[b0:b0 + ITEM_BLOCK]
        c = ci[b0:b0 + ITEM_BLOCK]
        ids = fids_c[g, c].long()
        dead = (ids < 0) | (ids >= nl_real)
        rows = tbl[torch.clamp(ids, 0, tbl.shape[0] - 1)]
        rows = torch.where(dead[..., None], torch.zeros_like(rows), rows)
        far, seg, opn, big = classify(rows, glo[g], ghi[g], oac[g], s_l,
                                      theta2, use_relative, leaf_cap, last)
        if record:
            keys[3, g, c] = torch.where(far, ids.to(torch.int32) + lvl_base,
                                        torch.full_like(keys[3, g, c], IMAX))
        else:
            rows_far = rows.clone()
            rows_far[..., R_MASS] = torch.where(
                far, rows[..., R_MASS], torch.zeros_like(rows[..., 0]))
            da, dp = far_tile(rows_far, xc[g], te[g], gc[g], need_pot)
            acc.index_add_(0, g, torch.cat([da, dp[..., None]], dim=-1))
        ri = rows.to(torch.int32)
        imax = torch.full_like(ri[..., 0], IMAX)
        keys[0, g, c] = torch.where(
            seg, ri[..., R_NSTART] * 32 + torch.clamp(ri[..., R_CNT], max=31),
            imax)
        keys[1, g, c] = torch.where(
            opn, ri[..., R_CSTART] * 16 + ri[..., R_CCNT], imax)
        keys[2, g, c] = torch.where(big, ids.to(torch.int32), imax)
    segk, openk, bigk, fark = keys.reshape(4, ng, W).unbind(0)
    if record:
        return fark, segk, openk, bigk
    return acc, segk, openk, bigk


def far_level(fids, n_live, tbl, nl_real: int, s_l, xc, te, glo, ghi, oac,
              *, theta2: float, use_relative: bool, leaf_cap: int,
              last: bool, need_pot: bool, record: bool = False,
              lvl_base: int = 0):
    """One level of the walk for every group.

    fids (ng, W) int32 level-local node ids (-1 = empty); n_live (ng,)
    int32 live frontier widths; tbl (cap, 16) float32 level node rows
    (``pack_tree``); nl_real: real node count of the level; s_l () float32
    cell size (+ 2 drift); xc (ng, 64, 3) group-centred targets; te (ng, 64)
    target softenings; glo/ghi (ng, 3) group bounding boxes; oac (ng,)
    relative-criterion thresholds. With ``record`` xc, te and need_pot are
    not read (xc and te may be None) and lvl_base is the level's flat node
    offset.

    Returns (acc (ng, 64, 4) float32 [ax ay az pot], segk, openk, bigk
    (ng, W) int32), or with ``record`` (fark, segk, openk, bigk)."""
    if not fids.is_cuda:
        return far_level_plain(fids, n_live, tbl, nl_real, s_l, xc, te, glo,
                               ghi, oac, theta2=theta2,
                               use_relative=use_relative, leaf_cap=leaf_cap,
                               last=last, need_pot=need_pot, record=record,
                               lvl_base=lvl_base)
    from .._build import check_cuda, kernels_lib, launch_args

    ng, W = fids.shape
    specs = dict(fids=(fids, torch.int32, (ng, W)),
                 n_live=(n_live, torch.int32, (ng,)),
                 tbl=(tbl, torch.float32, (tbl.shape[0], 16)),
                 s_l=(s_l, torch.float32, ()),
                 glo=(glo, torch.float32, (ng, 3)),
                 ghi=(ghi, torch.float32, (ng, 3)),
                 oac=(oac, torch.float32, (ng,)))
    if not record:
        specs.update(xc=(xc, torch.float32, (ng, G, 3)),
                     te=(te, torch.float32, (ng, G)))
    check_cuda("far_level", **specs)
    acc = None if record else torch.empty(ng, G, 4, dtype=torch.float32,
                                          device=fids.device)
    keys = torch.empty(4 if record else 3, ng, W, dtype=torch.int32,
                       device=fids.device)
    err = kernels_lib().far_level_launch(*launch_args(
        tbl, int(tbl.shape[0]), int(nl_real), fids, n_live, ng, W, s_l,
        None if record else xc, None if record else te, glo, ghi, oac,
        float(theta2), int(use_relative), float(leaf_cap), int(last),
        int(need_pot), int(record), int(lvl_base), acc, keys[0], keys[1],
        keys[2], keys[3] if record else None))
    if err:
        raise RuntimeError(f"far_level kernel launch failed: CUDA error "
                           f"{err}")
    if record:
        far_level.record_launches += 1
        return keys[3], keys[0], keys[1], keys[2]
    far_level.launches += 1
    return acc, keys[0], keys[1], keys[2]


far_level.launches = 0          # launches of the walk (far field) mode
far_level.record_launches = 0   # launches of the record mode
