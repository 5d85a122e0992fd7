"""The least time one H100 could take for a kernel's work: the larger of
the bytes the function must move (each input read once, each output
written once) over the memory rate, and the operations it does on these
inputs over the float32 rate outside the tensor cores.

Peaks of the H100 SXM (NVIDIA's data sheet, at the 700 W power limit):
67 TFLOP/s float32 without tensor cores, 3.35 TB/s HBM3. The 67 TFLOP/s
is the FMA rate (132 SMs x 128 lanes x 2 operations x 1.98 GHz): an add
and a multiply fused into one instruction count as two operations here, so
a kernel built without FMA (``_build.py``: only the walk's classification
kernel, for its bit-equal decisions) can reach at most half of its bound.
The operation counts are those the function needs, counted from the CUDA
sources (each add, multiply, min/max, compare, division and square root as
one), not what the kernels happen to execute: the softened kernels on their
Newtonian branch (1/r^3 and -1/r, not the softened polynomial), and a
quantity that depends only on the node, or on the node and the group, once
per list entry rather than once per pair. Near pairs inside the softening
length take the longer softened branch; counting them all at the
Newtonian cost keeps the bound a lower bound. Where the work depends on
the data it is counted from this call's inputs: live frontier or list
entries, accepted nodes, covered particles, valid targets.
"""

from __future__ import annotations

import torch

PEAK_F32 = 67e12        # float32 operations per second, no tensor cores
PEAK_BYTES = 3.35e12    # HBM bytes per second

# far pair (csrc/far_list.cu, ops/far_list.py contract), no potential:
# monopole 24 (c.x 5, r^2 4, sqrt, h 2, r >= h, 1/r^3 3, m/r^3, the sums
# of fac and fac c 7), quadrupole 51 (m > 0, 1/r, r^-5 and r^-7 4, x.u 5,
# x.Q.x 11, d.Q.d 3, the sums of w5 u 6, w5 Q 12, t7 2, t7 c 6), counted
# on the expansion |x|^2 + |c|^2 - 2 x.c of fused_force.far_tile
FAR_PAIR_OPS = 75
FAR_ENTRY_OPS = 25      # ... per (group, node): |c|^2 5, u = Q c 15, c.u 5
FAR_PAIR_POT_OPS = 5    # ... the potential: -1/r, m (-1/r), d.Q.d r^-5, sums
# near pair (ops/near_kernel.py contract), no potential: d 3, r 6, h 2,
# r >= h, 1/r^3 3, m/r^3, the sums of fac d 6
NEAR_PAIR_OPS = 22
NEAR_PAIR_POT_OPS = 3   # ... the potential: -1/r, m (-1/r), its sum
CLASSIFY_OPS = 30       # csrc/far_kernel.cu classify, per node
ROW_BYTES = 64          # one packed node row / table row
CLASS_ROW_BYTES = 36    # ... the fields classification reads: com, mass,
                        # count, node_start, child_start, child_count, bmax^2
NODE_IN_BYTES = 44      # gather_nodes: com, mass, quadrupole, eps_max
PART_BYTES = 20         # one particle's pos, mass, eps
# the range mode of far_level: per node the range test (3 x (2 differences,
# 2 max, 1 difference), d^2 5, compare, count > 0, leaf) on the range row's
# centre, count, node_start, child_start, child_count
RANGE_OPS = 23
RANGE_ROW_BYTES = 32
# candidate emission (csrc/sidm_emit.cu), per (target, staged particle)
# pair: d 3, r^2 5, compare, type, self (the count mode: + sqrt)
EMIT_PAIR_OPS = 11
SRC_BYTES = 16          # one source: x, y, z, aux
SLOT_BYTES = 24         # one target slot: position, radius, type, id
# gated DSMC tile (csrc/sidm_gated.cu), per live candidate pair: d 3, r^2
# 5, sqrt, r < h, pending, u, W(u) 7, / h^3, w 3, v^2 5, sqrt, sigma v,
# P 4, sum, P > 0, log and max 2, Gumbel 8 (clamp 2, scale, 2 logs, 2
# negations, convert), key, compare; a candidate out of range or pending
# stops after its first 12
GATED_PAIR_OPS = 46
GATED_MISS_OPS = 12
GATED_TARGET_BYTES = 64  # tid, ncand, radius, dt, row in; four outputs
CAND_ROW_BYTES = 32      # one candidate's row [pos3 vel3 mass aux]
# the walk's DSMC segment pass (csrc/sidm_near.cu): the gated tile's pair
# math (GATED_PAIR_OPS per live pair, GATED_MISS_OPS per other (live
# slot, segment particle) pair); per slot its position, velocity, h, dt,
# type and id in and its four outputs
NEAR_SLOT_BYTES = 56


def bound_ms(ops: float, nbytes: float):
    """(least milliseconds, "operations" or "bytes": which one bounds)."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _n(x) -> int:
    return int(x) if not isinstance(x, torch.Tensor) else int(x.item())


def far_level_work(kw: dict, cnt):
    """(ops, bytes) of one ``far_level`` call with keyword arguments
    ``kw`` under its compacted contract; cnt: the call's counts
    (``far_kernel.C_*`` rows) on the same inputs.

    Bytes: the live frontier ids and the fields of its node rows that
    classification reads (each distinct row once: at most the level's
    rows), the group boxes and thresholds, the compacted outputs written
    (far ids, segment keys, next frontier, chunk keys) and the counts; in
    record mode the list counts and telemetry read and written.
    Operations: CLASSIFY_OPS per classified node. The walk's far field is
    ``far_list``'s call (``far_list_work``)."""
    from .ops.far_kernel import C_BK, C_FAR, C_NEXT, C_SEG, N_CNT

    fids, n_live, tbl = kw["fids"], kw["n_live"], kw["tbl"]
    ng, W = fids.shape
    live = _n(torch.sum(torch.clamp(n_live.long(), max=W)))
    c = cnt.long()
    written = _n(torch.sum(c[C_FAR]) + torch.sum(c[C_SEG])
                 + torch.sum(c[C_NEXT]) + torch.sum(c[C_BK]))
    rng = bool(kw.get("range_walk"))
    ops = (RANGE_OPS if rng else CLASSIFY_OPS) * live
    nbytes = (4 * (live + ng) + 28 * ng
              + (RANGE_ROW_BYTES if rng else CLASS_ROW_BYTES)
              * min(tbl.shape[0], live) + 4 * written + 4 * N_CNT * ng)
    if kw.get("lists") is not None:
        nbytes += 2 * 4 * (2 + 5) * ng
    return ops, nbytes


def far_level_dense_work(kw: dict):
    """(ops, bytes) of the same classification under the former
    dense-plane contract (three (ng, W) int32 key planes written per walk
    level, four per record level), for comparison; without the far field,
    which that contract fused into the same kernel."""
    fids, n_live, tbl = kw["fids"], kw["n_live"], kw["tbl"]
    ng, W = fids.shape
    live = _n(torch.sum(torch.clamp(n_live.long(), max=W)))
    ops = CLASSIFY_OPS * live
    nbytes = 4 * (live + ng) + 28 * ng + ROW_BYTES * min(tbl.shape[0], live)
    planes = 3 if kw.get("lists") is None else 4
    return ops, nbytes + 4 * planes * ng * W


def near_level_work(kw: dict, nvalid):
    """(ops, bytes) of one ``near_level`` call; nvalid (ng,) valid
    targets per group."""
    keys, n_seg, pos_s = kw["keys"], kw["n_seg"], kw["pos_s"]
    ng, K = keys.shape
    live = torch.arange(K, device=keys.device)[None, :] < n_seg[:, None]
    cnt = torch.where(live, keys & 31, torch.zeros_like(keys)).long()
    per_group = torch.sum(cnt, dim=1)
    per = NEAR_PAIR_OPS + (NEAR_PAIR_POT_OPS if kw["need_pot"] else 0)
    ops = per * _n(torch.sum(per_group * nvalid.long()))
    covered = min(pos_s.shape[0], _n(torch.sum(per_group)))
    nbytes = (4 * (_n(torch.sum(n_seg)) + ng) + PART_BYTES * covered
              + 16 * ng * 64 * 2)
    return ops, nbytes


def far_list_work(tbl, nf, nvalid, need_pot: bool):
    """(ops, bytes) of one ``far_list`` call: every listed node on every
    valid target of its group."""
    ng = nf.shape[0]
    per = FAR_PAIR_OPS + (FAR_PAIR_POT_OPS if need_pot else 0)
    ops = (per * _n(torch.sum(nf.long() * nvalid.long()))
           + FAR_ENTRY_OPS * _n(torch.sum(nf.long() * (nvalid > 0))))
    entries = _n(torch.sum(nf.long()))
    nbytes = (4 * (entries + ng) + ROW_BYTES * min(tbl.shape[0], entries)
              + 12 * ng + 16 * ng * 64 * 2)
    return ops, nbytes


def gather_nodes_work(M: int, ids):
    """(ops, bytes) of one ``gather_nodes`` call on a tree of M nodes: the
    ids, each distinct node's com, mass, quadrupole and eps read once, the
    rows written."""
    n = ids.numel()
    return 0, 4 * n + NODE_IN_BYTES * min(M, n) + ROW_BYTES * n


def gather_work(tbl, ids, rowsum: bool):
    """(ops, bytes) of one ``gather_rows``/``gather_rowsum`` call."""
    n = ids.numel()
    out = 4 if rowsum else ROW_BYTES
    return (15 * n if rowsum else 0,
            4 * n + out * n + ROW_BYTES * min(tbl.shape[0], n))


def emit_work(keys, nn, gidx, n: int, written=None, count_mode=False):
    """(ops, bytes) of one ``sidm_emit`` call: EMIT_PAIR_OPS (+1 for the
    count mode's square root) per (valid target, covered particle) pair of
    each group; bytes: the live keys, each covered source once (at most
    n), the target slots, and per valid target its count (and demand),
    plus the candidate ids written (``written``: the sum of ncand)."""
    L = keys.shape[1]
    live = torch.arange(L, device=keys.device)[None, :] < nn[:, None].long()
    cov = torch.sum(torch.where(live, keys & 31, 0), dim=1).long()
    nv = torch.sum(gidx >= 0, dim=1).long()
    pairs = _n(torch.sum(cov * nv))
    ops = (EMIT_PAIR_OPS + int(count_mode)) * pairs
    nt = _n(torch.sum(nv))
    nbytes = (4 * _n(torch.sum(torch.clamp(nn.long(), max=L)))
              + SRC_BYTES * min(_n(torch.sum(cov)), n)
              + SLOT_BYTES * gidx.numel()
              + (4 if count_mode else 8) * nt
              + (0 if written is None else 4 * _n(written)))
    return ops, nbytes


def gated_work(tid, ncand, cnt, cand):
    """(ops, bytes) of one ``sidm_gated`` call on the targets ``tid``
    (-1 = unused) with the counts ``cnt`` it returned: GATED_PAIR_OPS per
    live pair and GATED_MISS_OPS per other candidate; bytes: per target
    GATED_TARGET_BYTES, its candidate ids, and each distinct candidate's
    row once."""
    t = tid[tid >= 0].long()
    pairs = _n(torch.sum(ncand[t].long()))
    ok = _n(torch.sum(cnt[t].long()))
    ops = GATED_PAIR_OPS * ok + GATED_MISS_OPS * (pairs - ok)
    K = cand.shape[1]
    c = cand[t]
    live = torch.arange(K, device=c.device)[None, :] < ncand[t][:, None]
    distinct = _n(torch.unique(c[live]).numel())
    nbytes = (GATED_TARGET_BYTES * t.numel() + 4 * pairs
              + CAND_ROW_BYTES * distinct)
    return ops, nbytes


def near_dsmc_work(keys, nn, gidx, gh, ncnt):
    """(ops, bytes) of one ``sidm_near`` call with the counts ``ncnt`` it
    returned: GATED_PAIR_OPS per live pair and GATED_MISS_OPS per other
    (live slot, covered particle) pair of each group; bytes: the live
    keys, each distinct covered particle's row once, every slot's inputs
    and outputs."""
    from .ops.fused_range import segment_particles
    L = keys.shape[1]
    live = torch.arange(L, device=keys.device)[None, :] < nn[:, None].long()
    cov = torch.sum(torch.where(live, keys & 31, 0), dim=1).long()
    nv = torch.sum((gidx >= 0) & (gh > 0), dim=1).long()
    pairs = _n(torch.sum(cov * nv))
    ok = _n(torch.sum(ncnt.long()))
    ops = GATED_PAIR_OPS * ok + GATED_MISS_OPS * (pairs - ok)
    idx, val = segment_particles(keys, nn)
    distinct = _n(torch.unique(idx[val]).numel())
    nbytes = (4 * _n(torch.sum(torch.clamp(nn.long(), max=L)))
              + CAND_ROW_BYTES * distinct + NEAR_SLOT_BYTES * gidx.numel())
    return ops, nbytes
