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
# the range walk (csrc/range_walk.cu): per classified cell the range test
# (3 x (2 differences, 2 max, 1 difference), d^2 5, compare, count > 0,
# leaf) on the range row's centre, count, node_start, child_start,
# child_count
RANGE_OPS = 23
RANGE_ROW_BYTES = 32
RANGE_GROUP_BYTES = 28   # ... per group its box and pad in
RANGE_TELE_BYTES = 68    # ... and its count and 8 int64 telemetry out
# candidate emission (csrc/sidm_emit.cu), per (target, staged particle)
# pair of a batch the target may reach: d 3, r^2 5, compare, type, self
# (the count mode compares r^2 with a per-target bound instead of taking
# the root: the same count)
EMIT_PAIR_OPS = 11
# ... its box test (may_reach) per (valid target, batch of 32 staged
# particles): 3 x (2 differences, 2 max), d^2 5, the margin 2, compare;
# and per staged particle its share of the batch's box (6 min/max)
EMIT_BOX_OPS = 20
EMIT_BOX_PART_OPS = 6
EMIT_ROUND = 2048       # csrc/sidm_emit.cu kCap: particles staged a round
EMIT_SCAN = 512         # csrc/seg_rounds.cuh kScan: keys scanned a round
EMIT_CHUNK = 1 << 17    # batches tested at once in emit_reach
SRC_BYTES = 16          # one source: x, y, z, aux
SLOT_BYTES = 24         # one target slot: position, radius, type, id
# gated DSMC tile (csrc/sidm_gated.cu), per live candidate pair: d 3, r^2
# 5, sqrt, r < h, pending, u, W(u) 7, / h^3, w 3, v^2 5, sqrt, sigma v,
# P 4, sum, P > 0, log and max 2, Gumbel 8 (clamp 2, scale, 2 logs, 2
# negations, convert), key, compare; a candidate out of range or pending
# stops after its first 12
GATED_PAIR_OPS = 46
GATED_MISS_OPS = 12
GATED_TARGET_BYTES = 48  # tid, ncand, radius, dt, row in
GATED_OUT_BYTES = 16     # ptot, cnt, bestk, bestj of every one of n rows
CAND_ROW_BYTES = 32      # one candidate's row [pos3 vel3 mass aux]
# the walk's DSMC segment pass (csrc/sidm_near.cu): the gated tile's pair
# math (GATED_PAIR_OPS per live pair, GATED_MISS_OPS per other (live
# slot, segment particle) pair); per slot its position, velocity, h, dt,
# type and id in and its four outputs
NEAR_SLOT_BYTES = 56
# the hash grid (csrc/hash_knn.cu, csrc/hash_scan.cu): one bucket's start
# and count; per row the k-th-neighbour radius reads its position and aux
# (the type), the scan the whole row and its particle id
BUCKET_BYTES = 8
KNN_ROW_BYTES = 16
SCAN_ROW_BYTES = 36
# ... H1 per row read in an iteration: the type (remainder 2, compare),
# d 3, r^2 5, the k-list's threshold compare (the stencil's integer hashing
# is not float work: not counted); per query its position, type and h in,
# h, count, overflow, need, clip and rows read out
KNN_ROW_OPS = 11
KNN_QUERY_BYTES = 44
# ... H2 per row up to the crossing: the type 3, d 3, r^2 5, sqrt, r < h,
# self and pending 2; per valid pair the term: u, W(u) 7, / h^3, w 3,
# v^2 5, sqrt, sigma v, P 4, the running sum and its compare; per target
# its id, position, velocity, h, type, uniform and dt in, partner, hit,
# need, clip and rows read out
SCAN_ROW_OPS = 16
SCAN_PAIR_OPS = 26
SCAN_TARGET_BYTES = 64
# ... H4 (csrc/hash_veldisp.cu) reads the whole row; per row read the
# type 3, d 3, r^2 5, sqrt, r < h; per neighbour in float32 u, W(u) 7,
# / h^3, m W, and in float64 the sums of m W, v (3) and |v|^2 (3 products,
# 3 adds), each counted twice (the H100's float64 rate outside the tensor
# cores, 34 TFLOP/s, is half the float32 one); per query its position,
# type and h in, count, need, clip, rows read and the float64 rho, sum v
# (3) and sum |v|^2 out
VD_ROW_OPS = 13
VD_NGB_OPS = 10 + 2 * 10
VD_QUERY_BYTES = 76
# ... H5 (csrc/hash_sph.cu, sph_density_kernel) reads the whole row
# (CAND_ROW_BYTES); per row read the type 3, d 3, r^2 5, sqrt, r < h; per
# neighbour in float32 u, W(u) 7, * h^-3, m W (10), dW(u) 6, * h^-4, m dW,
# the max and division by r (10), dv 3, d.dv 5, its product, d x dv 9 and
# its 3 products (21), and in float64 the sums of m W, divv and rot (5
# adds, each counted twice: the float64 rate is half the float32 one); per
# query its position, velocity, type and h in, count, need, clip, rows read
# and the float64 rho, divv and rot (3) out
SPH_ROW_OPS = 13
SPH_NGB_OPS = 10 + 10 + 21 + 2 * 5
SPH_QUERY_BYTES = 88
# ... H6 (csrc/hash_sph.cu, sph_hydro_kernel) per row read its position
# and aux and the row's particle id (self test), the type 3, d 3, r^2 5,
# sqrt, r < h; per pair (both halves: a synchronized step's gas is all
# active) u, dW 6, / h^4, dv 3, d.dv 5, h_ij, c_ij, rho_ij 6, mu 5, the
# viscosity 10 and its limiter 11, P/rho^2 of the row 4, pp 4, r_safe, the
# gathered term 5 and its 5 products, the scattered term 4 and its 5
# products, and the 8 float64 adds, each counted twice; bytes: the wide
# row (48) and its particle id (4); per query its position, velocity,
# type, h, id and 8 scalars in, its pairs, need, clip and rows read out
# and its float64 acc (3) and dt_egy written
HYDRO_ROW_OPS = 13
HYDRO_PAIR_OPS = 1 + 6 + 1 + 3 + 5 + 6 + 5 + 10 + 11 + 4 + 4 + 1 + 5 + 5 \
    + 4 + 5 + 2 * 8
HYDRO_ROW_BYTES = 48 + 4
HYDRO_QUERY_BYTES = 68 + 16 + 32
# the tree SPH engine (csrc/range_walk.cu's hmax mode, csrc/tree_sph.cu):
# T1 adds to the range test hmax + drift, its square and the max with pad^2
RANGE_HMAX_OPS = RANGE_OPS + 3
# T2 and T3 per (live slot, staged particle) pair: the gas test; per
# (live slot, staged gas particle) pair: d 3, r^2 5, sqrt, r < h (T3: the
# clamp of h_j and two compares, 12)
TREE_STAGE_OPS = 1
TREE_DENS_GAS_OPS = 10
TREE_HYDRO_GAS_OPS = 12
# ... T2 per neighbour: H5's neighbour terms (SPH_NGB_OPS); its count
# mode the count's add
TREE_DENS_NGB_OPS = SPH_NGB_OPS
TREE_COUNT_NGB_OPS = 1
# ... T3 per pair: both halves' dW 2 x (division, dW 6, / h^4) and h_j^4
# 2, dv 3, d.dv 5, h_ij, c_ij, rho_ij 6, mu 5, f_ij 2, the viscosity 9,
# msum 2, r_safe, two limiters 2 x 10, P/rho^2 of j 4, pp 4, the term 8,
# its 4 products and the 4 float64 adds, each counted twice
TREE_HYDRO_PAIR_OPS = (2 * 8 + 2 + 3 + 5 + 6 + 5 + 2 + 9 + 2 + 1 + 2 * 10
                       + 4 + 4 + 8 + 4 + 2 * 4)
# bytes: per staged particle its first 16 B [x y z aux] (T3 also its h);
# per neighbour (T2) the row's second 16 B, per pair (T3) its other 48 B;
# per slot its inputs (T2: position, velocity, h, id 32 B; T3: position,
# velocity, 8 scalars, id 60 B) and its float64 outputs (T2 6, T3 5)
TREE_DENS_SLOT_BYTES = 32 + 48
TREE_HYDRO_SLOT_BYTES = 60 + 40


# The periodic modes (the TreePM split's short range, the Ewald direct
# sum). erf, erfc, exp, rint and each division and square root count as
# one operation each. The minimum image of one pair vector: 3 x (division,
# rint, multiply, subtract) over the plain difference.
MIN_IMAGE_OPS = 12
# far_level's periodic classification: the minimum-image gap 3 x (centre
# difference, division, rint, multiply, subtract, abs, half-width
# subtract) in place of the box gap's 3 x (2 differences, max), and the
# rcut reach test (2 square roots, add, compare, and)
CLASSIFY_PBC_OPS = CLASSIFY_OPS + 12 + 5
# near pair, periodic (csrc/near_kernel.cu pbc_pair), no potential: d 3,
# the minimum image, r 6, cut, h, x = a r, x^2, g (erf, exp, 2/sqrt(pi) x
# e^-x^2 3, difference, x^3 2, division, series select), a^3 g, 1/r^3 3,
# difference, m fac, the sums of fac d 6
NEAR_PBC_PAIR_OPS = 3 + MIN_IMAGE_OPS + 6 + 1 + 1 + 2 + 9 + 1 + 3 + 1 + 1 + 6
NEAR_PBC_POT_OPS = 6    # ... the potential: erf / r 2, -1/r, add, m, sum
# far pair, periodic (csrc/far_list.cu pbc_pair), no potential: d 3, the
# minimum image, r 6, cut, h, x and x^2 2, S (erfc, exp, 3), m/r^3 S 5, the
# sums of fac d 6; the Newtonian-range screened quadrupole: r >= h, m > 0,
# 1/r, r^-2, r^-5 2, E (exp, 3), cA 10, cB 5, Q d 15, d.Q.d 5, tA 6, the
# sums 12 (per (target, node) pair: no per-node expansion in this mode)
FAR_PBC_PAIR_OPS = (3 + MIN_IMAGE_OPS + 6 + 1 + 1 + 2 + 5 + 5 + 6
                    + 4 + 2 + 4 + 10 + 5 + 15 + 5 + 6 + 12)
FAR_PBC_POT_OPS = 16    # ... the potential: erf / r or its series 3, -1/r,
                        # add, m, sum; the quadrupole's 10
# direct pair, periodic (csrc/direct.cu): the non-periodic pair, the
# minimum image, the Ewald cell of each axis 3 x (abs, scale, convert, 2
# clamps, difference), three trilinear lookups (8 weights of 2 products,
# 3 complements, 8 multiply-adds: 27 each), -sign(d) m F 3 x 3
DIRECT_PBC_PAIR_OPS = NEAR_PAIR_OPS + MIN_IMAGE_OPS + 18 + 3 * 27 + 9
DIRECT_PBC_POT_OPS = NEAR_PAIR_POT_OPS + 27 + 2   # ... and psi's lookup
# The free-space modes (PMVacuum): the periodic modes without the minimum
# image; the classification's box gap is the open walk's, plus the rcut
# reach test (2 square roots, add, compare, and)
CLASSIFY_VAC_OPS = CLASSIFY_OPS + 5
NEAR_VAC_PAIR_OPS = NEAR_PBC_PAIR_OPS - MIN_IMAGE_OPS
FAR_VAC_PAIR_OPS = FAR_PBC_PAIR_OPS - MIN_IMAGE_OPS
# The Ewald modes (PMGrid -1): the near pair is the periodic direct sum's
# (142 operations: the softened pair, the minimum image, the three
# lookups of the force correction and -sign(d) m F; 171 with the
# potential); the far pair is the Newtonian far pair with the minimum
# image and the same lookups and sums. Each call reads the interleaved
# table (16 B a grid point) once. The classification is the periodic one.
EWALD_NEAR_PAIR_OPS = DIRECT_PBC_PAIR_OPS
EWALD_NEAR_POT_OPS = DIRECT_PBC_POT_OPS
EWALD_FAR_PAIR_OPS = FAR_PAIR_OPS + MIN_IMAGE_OPS + 18 + 3 * 27 + 9
EWALD_FAR_POT_OPS = FAR_PAIR_POT_OPS + 27 + 2 + 2   # ... the trace term


def ewald_table_bytes(en: int) -> int:
    """The interleaved Ewald table of grid EN (csrc/ewald.cuh)."""
    return 16 * (en // 2 + 1) ** 3


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
    Operations: CLASSIFY_OPS per classified node (CLASSIFY_PBC_OPS with a
    periodic ``pbc``, the Ewald walk's included, CLASSIFY_VAC_OPS with the
    free-space one, in either mode). The walk's far field is
    ``far_list``'s call (``far_list_work``)."""
    from .ops.far_kernel import C_BK, C_FAR, C_NEXT, C_SEG, N_CNT

    fids, n_live, tbl = kw["fids"], kw["n_live"], kw["tbl"]
    ng, W = fids.shape
    live = _n(torch.sum(torch.clamp(n_live.long(), max=W)))
    c = cnt.long()
    written = _n(torch.sum(c[C_FAR]) + torch.sum(c[C_SEG])
                 + torch.sum(c[C_NEXT]) + torch.sum(c[C_BK]))
    pbc = kw.get("pbc")
    ops = (CLASSIFY_OPS if pbc is None else CLASSIFY_PBC_OPS
           if float(pbc[0]) > 0 else CLASSIFY_VAC_OPS) * live
    nbytes = (4 * (live + ng) + 28 * ng
              + CLASS_ROW_BYTES * min(tbl.shape[0], live) + 4 * written
              + 4 * N_CNT * ng)
    if kw.get("lists") is not None:
        nbytes += 2 * 4 * (2 + 5) * ng
    return ops, nbytes


def range_level_rows(kw: dict):
    """(classified cells, distinct real cells) of one level of the range
    walk: ``kw`` the level's arguments as ``fused_range.range_walk_plain``
    hands them to its ``on_level`` observer."""
    fids, n_live = kw["fids"], kw["n_live"]
    W = fids.shape[1]
    live = (torch.arange(W, device=fids.device)[None, :]
            < torch.clamp(n_live.long(), max=W)[:, None])
    ids = fids[live]
    real = ids[(ids >= 0) & (ids < kw["nl_real"])]
    return _n(torch.sum(live)), _n(torch.unique(real).numel())


def range_walk_work(levels, ng: int, seg_cap: int, hmax: bool = False):
    """(ops, bytes) of one whole range walk (``fused_range.
    range_segments``) of ng groups into (ng, seg_cap) lists; ``levels``:
    ``range_level_rows`` of each of its levels. Operations: RANGE_OPS
    (RANGE_HMAX_OPS in the hmax mode, ``hmax``, kernel T1) per classified
    cell. Bytes: each level's distinct range rows once, each
    group's box and pad once, the whole key lists (IMAX tails included)
    and each group's count and telemetry written once; no frontier is
    counted (a level's frontier is not an input or an output of the
    walk)."""
    classified = sum(c for c, _ in levels)
    distinct = sum(d for _, d in levels)
    nbytes = (RANGE_ROW_BYTES * distinct + RANGE_GROUP_BYTES * ng
              + 4 * ng * seg_cap + RANGE_TELE_BYTES * ng)
    return (RANGE_HMAX_OPS if hmax else RANGE_OPS) * classified, nbytes


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
    """(ops, bytes) of one ``near_level`` call (its periodic or free-space
    mode with ``kw["pbc"]``, its Ewald mode with ``kw["ewald"]``); nvalid
    (ng,) valid targets per group."""
    keys, n_seg, pos_s = kw["keys"], kw["n_seg"], kw["pos_s"]
    ng, K = keys.shape
    live = torch.arange(K, device=keys.device)[None, :] < n_seg[:, None]
    cnt = torch.where(live, keys & 31, torch.zeros_like(keys)).long()
    per_group = torch.sum(cnt, dim=1)
    pbc, ewald = kw.get("pbc"), kw.get("ewald")
    pot = kw["need_pot"]
    tables = 0
    if ewald is not None:
        per = EWALD_NEAR_PAIR_OPS + (EWALD_NEAR_POT_OPS if pot else 0)
        tables = ewald_table_bytes(ewald.en)
    elif pbc is not None:
        per = ((NEAR_PBC_PAIR_OPS if float(pbc[0]) > 0 else NEAR_VAC_PAIR_OPS)
               + (NEAR_PBC_POT_OPS if pot else 0))
    else:
        per = NEAR_PAIR_OPS + (NEAR_PAIR_POT_OPS if pot else 0)
    ops = per * _n(torch.sum(per_group * nvalid.long()))
    covered = min(pos_s.shape[0], _n(torch.sum(per_group)))
    nbytes = (4 * (_n(torch.sum(n_seg)) + ng) + PART_BYTES * covered
              + 16 * ng * 64 * 2 + tables)
    return ops, nbytes


def far_list_work(tbl, nf, nvalid, need_pot: bool, periodic: bool = False,
                  vacuum: bool = False, ewald_en: int = 0):
    """(ops, bytes) of one ``far_list`` call: every listed node on every
    valid target of its group (``periodic``: the periodic mode, which also
    reads each row's trace and has no per-entry expansion; ``vacuum``: the
    free-space mode, the same without the minimum image; ``ewald_en`` > 0:
    the Ewald mode with its table of grid EN, no per-entry expansion)."""
    ng = nf.shape[0]
    pairs = _n(torch.sum(nf.long() * nvalid.long()))
    entries = _n(torch.sum(nf.long()))
    rows = min(tbl.shape[0], entries)
    if ewald_en:
        ops = (EWALD_FAR_PAIR_OPS + (EWALD_FAR_POT_OPS if need_pot else 0)) \
            * pairs
        return ops, (4 * (entries + ng) + (ROW_BYTES + 4) * rows
                     + 16 * ng * 64 * 2 + ewald_table_bytes(ewald_en))
    if periodic or vacuum:
        ops = ((FAR_PBC_PAIR_OPS if periodic else FAR_VAC_PAIR_OPS)
               + (FAR_PBC_POT_OPS if need_pot else 0)) * pairs
        return ops, (4 * (entries + ng) + (ROW_BYTES + 4) * rows
                     + 16 * ng * 64 * 2)
    per = FAR_PAIR_OPS + (FAR_PAIR_POT_OPS if need_pot else 0)
    ops = (per * pairs
           + FAR_ENTRY_OPS * _n(torch.sum(nf.long() * (nvalid > 0))))
    nbytes = (4 * (entries + ng) + ROW_BYTES * rows
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


def emit_batches(keys, nn):
    """The emission kernel's batches of 32 staged particles: each group's
    live keys taken in rounds (``csrc/seg_rounds.cuh`` plan: from the
    round's first key, the longest run of at most EMIT_SCAN keys whose
    particles fit EMIT_ROUND), each round's particles cut into batches of
    32 in staged order. Returns (staged sorted ids (P,), batch of each
    (P,), group of each batch (nb,)), in staged order."""
    from .ops.fused_force import IMAX
    B, L = keys.shape
    dev = keys.device
    col = torch.arange(L, device=dev)[None, :]
    nk = torch.clamp(nn.long(), 0, L)[:, None]
    cnt = torch.where((col < nk) & (keys != IMAX), keys & 31, 0).long()
    inc = torch.cumsum(cnt, 1)
    ex = torch.cat([inc - cnt, inc[:, -1:]], 1)     # (B, L + 1)
    rnd = torch.zeros_like(cnt)                     # each key's round
    at = torch.zeros_like(cnt)                      # ... and offset there
    c0 = torch.zeros_like(nk)
    r = 0
    while bool(torch.any(c0 < nk)):
        base = torch.gather(ex, 1, c0)
        take = ((col >= c0) & (col < torch.minimum(c0 + EMIT_SCAN, nk))
                & (inc - base <= EMIT_ROUND))
        rnd = torch.where(take, r, rnd)
        at = torch.where(take, ex[:, :L] - base, at)
        c0 = c0 + torch.sum(take, 1, keepdim=True)
        r += 1
    gk, kk = torch.nonzero(cnt > 0, as_tuple=True)
    c = cnt[gk, kk]
    rep = torch.repeat_interleave(torch.arange(c.numel(), device=dev), c)
    i = torch.arange(rep.numel(), device=dev) - (torch.cumsum(c, 0) - c)[rep]
    ids = (keys[gk, kk].long() >> 5)[rep] + i
    g = gk[rep]
    tag = ((g * max(r, 1) + rnd[gk, kk][rep]) * (EMIT_ROUND // 32)
           + (at[gk, kk][rep] + i) // 32)
    new = torch.ones_like(tag, dtype=torch.bool)
    new[1:] = tag[1:] != tag[:-1]
    return ids, torch.cumsum(new, 0) - 1, g[new]


def emit_reach(keys, nn, src, gt, gr, gidx):
    """Which (batch, slot) pairs the emission kernel takes: those of a
    valid slot whose radius may reach the batch's box of finite particles
    (``csrc/sidm_emit.cu`` may_reach, with the record mode's r^2 < r*r
    standing for the count mode's test, a few float32 ULPs away and far
    inside the test's 1e-4 margin). Returns (reach (nb, 64) bool, staged
    particles per batch (nb,), group of each batch (nb,)) over
    ``emit_batches``."""
    ids, batch, bgroup = emit_batches(keys, nn)
    nb = bgroup.numel()
    dev = keys.device
    size = torch.bincount(batch, minlength=nb)
    p = src[ids, :3]
    fin = torch.all(torch.isfinite(p), 1)
    at = batch[fin][:, None].expand(-1, 3)
    lo = torch.full((nb, 3), float("inf"), device=dev).scatter_reduce(
        0, at, p[fin], "amin")
    hi = torch.full((nb, 3), -float("inf"), device=dev).scatter_reduce(
        0, at, p[fin], "amax")
    reach = torch.zeros((nb, gidx.shape[1]), dtype=torch.bool, device=dev)
    for a in range(0, nb, EMIT_CHUNK):
        g = bgroup[a:a + EMIT_CHUNK]
        t = gt[g]
        d = torch.clamp(torch.maximum(lo[a:a + EMIT_CHUNK, None] - t,
                                      t - hi[a:a + EMIT_CHUNK, None]),
                        min=0.0)
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
              + d[..., 2] * d[..., 2])
        r = gr[g]
        reach[a:a + EMIT_CHUNK] = (gidx[g] >= 0) & ~(
            d2 > (r * r) * 1.0001 + 1e-30)
    return reach, size, bgroup


def emit_work(keys, nn, src, gt, gr, gidx, n: int, K: int = 0,
              count_mode=False, box: float = 0.0, counts=None):
    """(ops, bytes) of one ``sidm_emit`` call: EMIT_PAIR_OPS per (valid
    target, staged particle) pair of the batches the target may reach
    (``emit_reach``; with a periodic box, where the kernel skips nothing,
    of every batch), EMIT_BOX_OPS per (valid target, batch) box test and
    EMIT_BOX_PART_OPS per staged particle; bytes: the live keys, each
    covered source once (at most n), the target slots, and in count mode
    each valid target's count, in record mode the whole (n, K) candidate
    array (the wrapper fills it, the kernel writes the hits) and every
    row's count and demand. ``counts`` (a dict) receives the pairs, the
    reachable pairs and the box tests."""
    from .ops.fused_range import segment_totals_plain
    L = keys.shape[1]
    cov = segment_totals_plain(keys, nn).long()
    nv = torch.sum(gidx >= 0, dim=1).long()
    pairs = _n(torch.sum(cov * nv))
    if box > 0:
        reach_pairs, tests = pairs, 0
    else:
        reach, size, bgroup = emit_reach(keys, nn, src, gt, gr, gidx)
        reach_pairs = _n(torch.sum(torch.sum(reach, 1) * size))
        tests = _n(torch.sum(nv[bgroup]))
    ops = (EMIT_PAIR_OPS * reach_pairs + EMIT_BOX_OPS * tests
           + (0 if box > 0 else EMIT_BOX_PART_OPS * _n(torch.sum(cov))))
    if counts is not None:
        counts.update(pairs=pairs, reach_pairs=reach_pairs, box_tests=tests)
    nbytes = (4 * _n(torch.sum(torch.clamp(nn.long(), max=L)))
              + SRC_BYTES * min(_n(torch.sum(cov)), n)
              + SLOT_BYTES * gidx.numel()
              + (4 * _n(torch.sum(nv)) if count_mode else 4 * n * (K + 2)))
    return ops, nbytes


def segment_totals_work(keys, nn):
    """(ops, bytes) of one ``segment_totals`` call: a sum over the live
    keys (one operation each); bytes: the live keys, nn and the totals."""
    live = _n(torch.sum(torch.clamp(nn.long(), min=0, max=keys.shape[1])))
    return live, 4 * live + 8 * nn.numel()


def gated_work(tid, ncand, cnt, cand):
    """(ops, bytes) of one ``sidm_gated`` call on the targets ``tid``
    (-1 = unused) with the counts ``cnt`` it returned: GATED_PAIR_OPS per
    live pair and GATED_MISS_OPS per other candidate; bytes: per target
    GATED_TARGET_BYTES, its candidate ids, each distinct candidate's row
    once, and the (n,) outputs written whole (GATED_OUT_BYTES a row)."""
    t = tid[tid >= 0].long()
    pairs = _n(torch.sum(ncand[t].long()))
    ok = _n(torch.sum(cnt[t].long()))
    ops = GATED_PAIR_OPS * ok + GATED_MISS_OPS * (pairs - ok)
    K = cand.shape[1]
    c = cand[t]
    live = torch.arange(K, device=c.device)[None, :] < ncand[t][:, None]
    distinct = _n(torch.unique(c[live]).numel())
    nbytes = (GATED_TARGET_BYTES * t.numel() + 4 * pairs
              + CAND_ROW_BYTES * distinct + GATED_OUT_BYTES * cand.shape[0])
    return ops, nbytes


def near_dsmc_work(keys, nn, gidx, gh, ncnt):
    """(ops, bytes) of one ``sidm_near`` call with the counts ``ncnt`` it
    returned: GATED_PAIR_OPS per live pair and GATED_MISS_OPS per other
    (live slot, covered particle) pair of each group; bytes: the live
    keys, each distinct covered particle's row once, every slot's inputs
    and outputs."""
    from .ops.fused_range import (live_slots, segment_particles,
                                  segment_totals_plain)
    L = keys.shape[1]
    cov = segment_totals_plain(keys, nn).long()
    nv = live_slots(gidx, gh).long()
    pairs = _n(torch.sum(cov * nv))
    ok = _n(torch.sum(ncnt.long()))
    ops = GATED_PAIR_OPS * ok + GATED_MISS_OPS * (pairs - ok)
    idx, val = segment_particles(keys, nn)
    distinct = _n(torch.unique(idx[val]).numel())
    nbytes = (4 * _n(torch.sum(torch.clamp(nn.long(), max=L)))
              + CAND_ROW_BYTES * distinct + NEAR_SLOT_BYTES * gidx.numel())
    return ops, nbytes


def _bucket_rows(table, keys, cap: int):
    """(distinct buckets, rows of those buckets up to cap) of the key
    lists ``keys`` (each iteration's deduplicated bucket keys)."""
    k = torch.unique(torch.cat([x.reshape(-1) for x in keys])) if keys \
        else torch.zeros(0, dtype=torch.int64)
    rows = torch.clamp(table.bucket_count[k.to(
        table.bucket_count.device)].long(), max=cap)
    return k.numel(), _n(torch.sum(rows))


def knn_work(table, keys, scanned, n: int, cap: int):
    """(ops, bytes) of one ``knn_radius`` call on n queries: KNN_ROW_OPS
    per row read (``scanned``: rows read per query over the iterations,
    as the kernel and the plain version count them); bytes: the distinct
    buckets of ``keys`` (the plain version's key lists) and their rows up
    to cap once each (KNN_ROW_BYTES a row), the queries' inputs and
    outputs."""
    nb, rows = _bucket_rows(table, keys, cap)
    ops = KNN_ROW_OPS * _n(torch.sum(scanned.long()))
    return ops, BUCKET_BYTES * nb + KNN_ROW_BYTES * rows + KNN_QUERY_BYTES * n


def scan_work(table, keys, scanned, ok, tid, cap: int):
    """(ops, bytes) of one ``hash_scan`` call on the targets ``tid``:
    SCAN_ROW_OPS per row read up to each target's crossing (``scanned``)
    and SCAN_PAIR_OPS per valid pair among them (``ok``, the plain
    version's); bytes: the distinct buckets of ``keys`` once, their rows
    up to cap (at most the rows read) once, SCAN_TARGET_BYTES a target."""
    t = tid.long()
    nb, rows = _bucket_rows(table, keys, cap)
    read = _n(torch.sum(scanned[t].long()))
    ops = SCAN_ROW_OPS * read + SCAN_PAIR_OPS * _n(torch.sum(ok[t].long()))
    return ops, (BUCKET_BYTES * nb + SCAN_ROW_BYTES * min(rows, read)
                 + SCAN_TARGET_BYTES * t.numel())


def veldisp_work(table, keys, scanned, cnt, n: int, cap: int):
    """(ops, bytes) of one ``veldisp_sums`` call on n queries: VD_ROW_OPS
    per row read (``scanned``) and VD_NGB_OPS per neighbour (``cnt``);
    bytes: the distinct buckets of ``keys`` (the plain version's key list)
    and their rows up to cap once each (CAND_ROW_BYTES a row), the queries'
    inputs and outputs."""
    nb, rows = _bucket_rows(table, keys, cap)
    ops = (VD_ROW_OPS * _n(torch.sum(scanned.long()))
           + VD_NGB_OPS * _n(torch.sum(cnt.long())))
    return ops, BUCKET_BYTES * nb + CAND_ROW_BYTES * rows + VD_QUERY_BYTES * n


def sph_density_work(table, keys, scanned, cnt, n: int, cap: int):
    """(ops, bytes) of one ``sph_density_sums`` call (H5) on n queries:
    SPH_ROW_OPS per row read (``scanned``) and SPH_NGB_OPS per neighbour
    (``cnt``); bytes: the distinct buckets of ``keys`` (the plain
    version's key list) and their rows up to cap once each, the queries'
    inputs and outputs."""
    nb, rows = _bucket_rows(table, keys, cap)
    ops = (SPH_ROW_OPS * _n(torch.sum(scanned.long()))
           + SPH_NGB_OPS * _n(torch.sum(cnt.long())))
    return ops, (BUCKET_BYTES * nb + CAND_ROW_BYTES * rows
                 + SPH_QUERY_BYTES * n)


def hydro_work(table, keys, scanned, pairs, n: int, cap: int):
    """(ops, bytes) of one ``hydro_pairs`` call (H6) on n queries:
    HYDRO_ROW_OPS per row read and HYDRO_PAIR_OPS per (q, c) pair
    (``pairs``); bytes: the distinct buckets and their wide rows up to cap
    once each, the queries' inputs and outputs."""
    nb, rows = _bucket_rows(table, keys, cap)
    ops = (HYDRO_ROW_OPS * _n(torch.sum(scanned.long()))
           + HYDRO_PAIR_OPS * _n(torch.sum(pairs.long())))
    return ops, (BUCKET_BYTES * nb + HYDRO_ROW_BYTES * rows
                 + HYDRO_QUERY_BYTES * n)


def direct_work(n: int, T: int, need_pot: bool, en: int = 0):
    """(ops, bytes) of one ``direct_sum`` call: every (target, source) pair
    of n sources and T targets at NEAR_PAIR_OPS (plus NEAR_PAIR_POT_OPS
    with the potential; the same pair math as the near kernel's); bytes:
    the sources' PART_BYTES, the target ids, the accelerations (and
    potentials) written. ``en`` > 0: the periodic mode with Ewald tables of
    grid EN (DIRECT_PBC_* per pair; the four tables read once)."""
    if en:
        per = DIRECT_PBC_PAIR_OPS + (DIRECT_PBC_POT_OPS if need_pot else 0)
        tables = ewald_table_bytes(en)
    else:
        per = NEAR_PAIR_OPS + (NEAR_PAIR_POT_OPS if need_pot else 0)
        tables = 0
    return per * n * T, (PART_BYTES * n + 4 * T + (16 if need_pot else 12) * T
                         + tables)


def _tree_pairs(keys, nn, rows, live):
    """Per group its live slots and, over its segment keys, the staged
    particles, the staged gas ones and the distinct covered particles
    (each once, from the keys' ranges): (slot x staged pairs, slot x gas
    pairs, distinct particles, distinct gas particles)."""
    from .ops.fused_force import IMAX
    n, L = rows.shape[0], keys.shape[1]
    dev = keys.device
    ok = ((torch.arange(L, device=dev)[None, :] < nn[:, None].long())
          & (keys != IMAX))
    k = torch.where(ok, keys, torch.zeros_like(keys)).long()
    start = k >> 5
    end = start + torch.where(ok, k & 31, torch.zeros_like(k))
    gas = torch.remainder(rows[:, 3], 8.0) == 0
    gcum = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                      torch.cumsum(gas.long(), 0)])
    nv = torch.sum(live, dim=1).long()
    staged = _n(torch.sum(torch.sum(end - start, dim=1) * nv))
    staged_gas = _n(torch.sum(torch.sum(gcum[end] - gcum[start], dim=1)
                              * nv))
    diff = torch.zeros(n + 1, dtype=torch.long, device=dev)
    diff.index_add_(0, start[ok], torch.ones_like(start[ok]))
    diff.index_add_(0, end[ok], -torch.ones_like(end[ok]))
    cov = torch.cumsum(diff, 0)[:n] > 0
    return staged, staged_gas, _n(torch.sum(cov)), _n(torch.sum(cov & gas))


def tree_density_work(kw: dict, cnt):
    """(ops, bytes) of one ``fused_sph.tree_density_sums`` call (T2) with
    the keyword arguments ``kw`` (``sph_density_fused``'s ``on_pass``) and
    the neighbour counts ``cnt`` it returned: TREE_STAGE_OPS per (live slot,
    staged particle), TREE_DENS_GAS_OPS per (live slot, staged gas
    particle), TREE_DENS_NGB_OPS (TREE_COUNT_NGB_OPS in the count mode) per
    neighbour; bytes: the live keys, each distinct staged particle's first
    16 B and each distinct gas particle's second 16 B (not in the count
    mode) once, every slot's inputs and outputs."""
    from .ops.fused_sph import _live
    keys, nn = kw["keys"], kw["nn"]
    live = _live(kw["gidx"], kw["gh"])
    staged, staged_gas, u, ug = _tree_pairs(keys, nn, kw["rows"], live)
    ngb = TREE_COUNT_NGB_OPS if kw["count_only"] else TREE_DENS_NGB_OPS
    ops = (TREE_STAGE_OPS * staged + TREE_DENS_GAS_OPS * staged_gas
           + ngb * _n(torch.sum(cnt.long())))
    nbytes = (4 * _n(torch.sum(torch.clamp(nn.long(), max=keys.shape[1])))
              + 16 * u + (0 if kw["count_only"] else 16 * ug)
              + TREE_DENS_SLOT_BYTES * live.numel())
    return ops, nbytes


def tree_hydro_work(kw: dict, pairs):
    """(ops, bytes) of one ``fused_sph.tree_hydro_sums`` call (T3) with the
    keyword arguments ``kw`` and the pairs ``pairs`` it returned:
    TREE_STAGE_OPS per (live slot, staged particle), TREE_HYDRO_GAS_OPS
    per (live slot, staged gas particle), TREE_HYDRO_PAIR_OPS per pair;
    bytes: the live keys, each distinct staged particle's first 16 B and
    h, each distinct gas particle's other 48 B once, every slot's inputs
    and outputs."""
    from .ops.fused_sph import _live
    keys, nn = kw["keys"], kw["nn"]
    live = _live(kw["gidx"], kw["gq"][..., 0])
    staged, staged_gas, u, ug = _tree_pairs(keys, nn, kw["rows"], live)
    ops = (TREE_STAGE_OPS * staged + TREE_HYDRO_GAS_OPS * staged_gas
           + TREE_HYDRO_PAIR_OPS * _n(torch.sum(pairs.long())))
    nbytes = (4 * _n(torch.sum(torch.clamp(nn.long(), max=keys.shape[1])))
              + 20 * u + 48 * ug + TREE_HYDRO_SLOT_BYTES * live.numel())
    return ops, nbytes
