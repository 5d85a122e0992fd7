"""The hash-grid neighbour engine: multi-level hashed cell lists and the
k-th-neighbour radius (port of ``sidm_tpu/ops/neighbors.py``:
``make_payload``/``payload_type``/``payload_flag`` :58-72, ``_mix``,
``_cell_hash`` and ``_cell_coords`` :75-99, ``build_table`` :102,
``level_for_radius`` :150, ``gather_candidates`` :159, ``knn_radius``
:203, ``default_cell_size`` :232, ``setup_smoothing_lengths`` :254 and
``with_payload`` :289).

Particles are hashed into cubic cells at L dyadic levels (cell size
s_l = s0 2^l); all (level, type, cell) keys are sorted once per build and
bucket (start, count) tables give each cell's entries, whose payload rows
[pos3 vel3 mass aux] (aux = type + 8 pending) are stored in the sorted
order. A query of radius h reads the 27 stencil buckets of the smallest
level with s_l >= h, each up to ``cap`` rows, deduplicated in stencil order
(hash collisions and periodic wraps visit a bucket twice).

``build_table`` stays PyTorch (JAX computes it outside any kernel too): a
stable sort, a bincount and a cumsum. The uint32 hashing runs in int64
masked to 32 bits (``rng.mul32``), so that the keys, ``sorted_part`` and the
bucket tables are JAX's bit for bit. ``knn_radius`` is kernel H1
(``csrc/hash_knn.cu``, all iterations in one launch) on a CUDA tensor and
``knn_radius_plain`` on a CPU one.

Two rules differ from JAX, each so that the kernel and the plain version
decide alike:
* the level is the smallest l with s0 2^l >= h (exact in float32), where
  JAX takes ceil(log2(h / s0)) in float32; the two agree except where
  h / s0 rounds onto a power of two (tests/test_torch_neighbors.py holds
  them equal on its inputs);
* what JAX drops silently is counted: a bucket read past ``cap``
  (``need`` > cap: the largest bucket count a query reached) and a query
  whose level is clipped to L - 1 (``clip``: its stencil no longer covers
  its ball; ROADMAP C). Both ops keep JAX's fixed ``cap`` and drop exactly
  JAX's candidates; ``Simulation`` grows ``cap`` to the demand
  (``grown_cap``) and, for the velocity-dispersion and SPH grids, the
  levels (``grown_levels``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..rng import M32, mul32

PAYLOAD_DIM = 8
MAX_K = 128             # csrc/hash_knn.cu kMaxK: the k-list of a warp
MAX_LEVELS = 24         # the most levels a grown grid takes

_STENCIL = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def grown_cap(cap: int, need: int) -> int:
    """Rows per bucket for the pass after one whose largest bucket held
    ``need`` rows: ``need`` rounded up to 32 where it is past ``cap``."""
    return int(cap) if need <= cap else -(-int(need) // 32) * 32


def grown_levels(levels: int, clip: int, ratio: float) -> int:
    """Levels for the grid after a pass that clipped ``clip`` queries'
    levels: enough that the last level's cells s0 2^(L-1) reach the
    largest radius (``ratio`` = that radius / s0) with one level to spare,
    at least one more than ``levels``, at most MAX_LEVELS."""
    if not clip:
        return int(levels)
    want = max(levels + 1, int(np.ceil(np.log2(max(ratio, 1.0)))) + 2)
    return max(int(levels), min(want, MAX_LEVELS))


class NeighborTable(NamedTuple):
    rows: torch.Tensor          # (L*N, 8) payload in sorted entry order
    sorted_part: torch.Tensor   # (L*N,) int32 particle index per entry
    bucket_start: torch.Tensor  # (L*H,) int32
    bucket_count: torch.Tensor  # (L*H,) int32
    origin: torch.Tensor        # (3,)
    s0: torch.Tensor            # () base cell size
    box: float                  # box size (0 = non-periodic)
    n_levels: int
    n_hash: int

    @property
    def geom(self) -> torch.Tensor:
        """(4,) float32 [origin, s0]: the kernels' view of the grid."""
        return torch.cat([self.origin.reshape(3),
                          self.s0.reshape(1)]).to(torch.float32).contiguous()


class Knn(NamedTuple):
    """``knn_radius``'s result: JAX's (h, count at h, overflow of the last
    iteration) and what the port adds: ``need`` the largest bucket count a
    query reached in any iteration (> cap: rows dropped), ``clip`` whether
    any iteration's level was clipped to L - 1, ``scanned`` the rows read
    over the iterations (the work of ``bounds.knn_work``)."""
    h: torch.Tensor
    cnt: torch.Tensor
    ovf: torch.Tensor
    need: torch.Tensor
    clip: torch.Tensor
    scanned: torch.Tensor


def make_payload(pos, vel, mass, ptype, flag=None):
    """The payload rows [pos3 vel3 mass aux], aux = type + 8 flag."""
    aux = torch.clamp(ptype, 0, 7).to(pos.dtype)
    if flag is not None:
        aux = aux + 8.0 * flag.to(pos.dtype)
    return torch.cat([pos, vel, mass[:, None], aux[:, None]], dim=1)


def payload_type(rows):
    return torch.remainder(rows[..., 7], 8.0).to(torch.int32)


def payload_flag(rows):
    return rows[..., 7] >= 8.0


def _mix(h):
    h = h ^ (h >> 16)
    h = mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _cell_hash(ix, iy, iz, ptype, n_hash: int):
    """uint32 hash of a (cell, type) key mod n_hash, as int64; negative
    cells wrap to uint32 as JAX's casts do."""
    h = (mul32(ix & M32, 0x9E3779B1) ^ mul32(iy & M32, 0x85EBCA77)
         ^ mul32(iz & M32, 0xC2B2AE3D)
         ^ mul32((ptype.to(torch.int64) + 1) & M32, 0x27D4EB2F))
    return _mix(h) % n_hash


def _cell_coords(pos, origin, s, box: float):
    """(int64 cells of pos at cell size s, dims (periodic: cells per side,
    else None))."""
    if box > 0:
        # tensor / tensor: a Python number over a tensor is its reciprocal
        # times the number in PyTorch, rounded twice
        boxt = torch.as_tensor(box, dtype=pos.dtype, device=pos.device)
        dims = torch.clamp(torch.floor(boxt / s), min=1.0)
        cell = torch.floor((pos - origin) / (boxt / dims)).to(torch.int64)
        dims = dims.to(torch.int64)
        return torch.remainder(cell, dims), dims
    return torch.floor((pos - origin) / s).to(torch.int64), None


def _wrap(pos, box: float):
    return pos - box * torch.floor(pos / box) if box > 0 else pos


def build_table(pos, ptype, valid, *, s0, box: float = 0.0,
                n_levels: int = 10, n_hash: int = 1 << 18,
                payload=None) -> NeighborTable:
    """The table; ``payload`` defaults to position-only rows (velocity and
    mass 0). ``s0`` a float or a 0-d tensor (read on the device)."""
    n = pos.shape[0]
    dtype, dev = pos.dtype, pos.device
    box = float(box)
    if payload is None:
        payload = make_payload(pos, torch.zeros_like(pos),
                               torch.zeros(n, dtype=dtype, device=dev), ptype)
    s0 = torch.as_tensor(s0, dtype=dtype, device=dev).reshape(())
    origin = (torch.zeros(3, dtype=dtype, device=dev) if box > 0
              else torch.min(pos, dim=0).values)
    posw = _wrap(pos, box)
    keys = []
    for lev in range(n_levels):
        c, _ = _cell_coords(posw, origin, s0 * (2.0 ** lev), box)
        h = _cell_hash(c[:, 0], c[:, 1], c[:, 2], ptype, n_hash)
        keys.append(torch.where(valid, lev * n_hash + h,
                                torch.full_like(h, n_levels * n_hash)))
    all_keys = torch.cat(keys)
    part = torch.arange(n, dtype=torch.int32, device=dev).repeat(n_levels)
    sorted_keys, order = torch.sort(all_keys, stable=True)
    sorted_part = part[order]
    lh = n_levels * n_hash
    counts = torch.bincount(sorted_keys, minlength=lh + 1)[:lh]
    starts = torch.cumsum(counts, 0) - counts
    return NeighborTable(
        rows=payload[sorted_part.long()].contiguous(),
        sorted_part=sorted_part.contiguous(),
        bucket_start=starts.to(torch.int32), bucket_count=counts.to(
            torch.int32), origin=origin, s0=s0, box=box, n_levels=n_levels,
        n_hash=n_hash)


def with_payload(table: NeighborTable, payload) -> NeighborTable:
    """Re-attach a (possibly wider) payload without re-sorting; column 7
    must stay the aux field."""
    return table._replace(rows=payload[table.sorted_part.long()]
                          .contiguous())


def level_for_radius(table: NeighborTable, h):
    """(level, clipped): the smallest l with s0 2^l >= h, at most L - 1,
    and whether s0 2^(L-1) < h clipped it."""
    lev = torch.zeros(h.shape, dtype=torch.int32, device=h.device)
    for lv in range(table.n_levels - 1):
        lev += (table.s0 * (2.0 ** lv) < h).to(torch.int32)
    clip = table.s0 * (2.0 ** (table.n_levels - 1)) < h
    return lev, clip


def stencil(table: NeighborTable, pos_q, ptype_q, h_q):
    """The queries' 27 bucket keys in stencil order: (key (B, 27) int64,
    dup (B, 27): visited earlier in the order, clipped (B,))."""
    lev, clip = level_for_radius(table, h_q)
    scale = torch.tensor([2.0 ** lv for lv in range(table.n_levels)],
                         dtype=pos_q.dtype, device=pos_q.device)
    s = table.s0 * scale[lev.long()]
    base, dims = _cell_coords(_wrap(pos_q, table.box), table.origin,
                              s[:, None], table.box)
    off = torch.tensor(_STENCIL, dtype=torch.int64, device=pos_q.device)
    c = base[:, None, :] + off[None]                       # (B, 27, 3)
    if dims is not None:
        c = torch.remainder(c, dims[:, None, :])
    key = (lev.to(torch.int64)[:, None] * table.n_hash
           + _cell_hash(c[..., 0], c[..., 1], c[..., 2], ptype_q[:, None],
                        table.n_hash))
    eq = key[:, :, None] == key[:, None, :]
    earlier = torch.ones(27, 27, dtype=torch.bool,
                         device=key.device).tril(-1)       # [j, i]: i < j
    dup = torch.any(eq & earlier[None], dim=2)
    return key, dup, clip


def gather_candidates(table: NeighborTable, pos_q, ptype_q, h_q, *,
                      cap: int):
    """Candidate neighbours of a block of queries in JAX's dense layout:
    (idx (B, 27 cap) int32, rows (B, 27 cap, dim), mask, overflow). The
    mask is type-exact; rows read per stencil bucket in its sorted order.
    The port's engines read the compact layout (``candidate_blocks``)."""
    key, dup, clip = stencil(table, pos_q, ptype_q, h_q)
    start = table.bucket_start[key].long()
    count = torch.where(dup, torch.zeros_like(start),
                        table.bucket_count[key].long())
    overflow = torch.any(count > cap, dim=1)
    rank = torch.arange(cap, dtype=torch.int64, device=pos_q.device)
    entry = start[:, :, None] + rank[None, None, :]
    mask = rank[None, None, :] < torch.clamp(count, max=cap)[:, :, None]
    entry = torch.clamp(entry, 0, table.sorted_part.shape[0] - 1)
    b = pos_q.shape[0]
    idx = table.sorted_part[entry].reshape(b, -1)
    rows = table.rows[entry].reshape(b, -1, table.rows.shape[-1])
    mask = mask.reshape(b, -1) & (payload_type(rows) == ptype_q[:, None])
    return idx, rows, mask, overflow


def min_image(d, box: float):
    return d - box * torch.round(d / box) if box > 0 else d


def _r2(rows, pos_q, box: float):
    d = [min_image(rows[..., c] - pos_q[:, None, c], box) for c in range(3)]
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


SLOT_BUDGET = 1 << 21   # candidate slots a plain-version block holds


class Block(NamedTuple):
    """A block of queries' candidates in the compact layout: each query's
    deduplicated buckets' rows, up to ``cap`` a bucket, in stencil then rank
    order (JAX's order without its masked slots), padded to the block's
    longest row."""
    sel: torch.Tensor       # (B,) query indices
    entry: torch.Tensor     # (B, M) table entry of each slot (0 past real)
    real: torch.Tensor      # (B, M) slot holds a row
    mask: torch.Tensor      # (B, M) ... of the query's type
    first: torch.Tensor     # (B,) JAX's slot 0: the first bucket's first entry


def entry_types(table: NeighborTable):
    """(L N,) int32 payload type of each table entry."""
    return payload_type(table.rows)


def candidate_blocks(table: NeighborTable, pos_q, ptype_q, h_q, *, cap: int,
                     budget: int = SLOT_BUDGET, keys: Optional[list] = None,
                     etype=None, chunk: int = 65536):
    """The queries' candidates as ``Block``s of at most ``budget`` slots
    (queries ordered by their row counts, so that a few long rows do not
    pad many short ones; a generator, each block made when it is taken),
    with the per-query stencil results (need (n,), clip (n,), rows read
    (n,)). ``keys``: a list that receives the
    deduplicated bucket keys (for ``bounds``); ``etype``: the table's
    ``entry_types`` (computed when not given)."""
    n, dev = pos_q.shape[0], pos_q.device
    if etype is None:
        etype = entry_types(table)
    st, cc, need, clip = [], [], [], []
    for c0 in range(0, n, chunk):
        key, dup, cl = stencil(table, pos_q[c0:c0 + chunk],
                               ptype_q[c0:c0 + chunk], h_q[c0:c0 + chunk])
        count = torch.where(dup, torch.zeros_like(key),
                            table.bucket_count[key].long())
        if keys is not None:
            keys.append(key[count > 0])
        st.append(table.bucket_start[key].long())
        cc.append(torch.clamp(count, max=cap))
        need.append(torch.max(count, dim=1).values)
        clip.append(cl)
    if n == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return iter(()), z, z.bool(), z
    start, cc = torch.cat(st), torch.cat(cc)
    incl = torch.cumsum(cc, dim=1)
    tot = incl[:, -1]
    order = torch.argsort(tot, descending=True, stable=True)
    tot_h = tot[order].cpu().numpy()

    def blocks():
        b0 = 0
        while b0 < n:
            m = max(int(tot_h[b0]), 1)
            b1 = min(n, b0 + max(budget // m, 1))
            sel = order[b0:b1]
            b0 = b1
            inc = incl[sel]
            slot = torch.arange(m, device=dev)[None, :].expand(sel.numel(),
                                                               m)
            cell = torch.clamp(torch.searchsorted(inc, slot.contiguous(),
                                                  right=True), max=26)
            real = slot < tot[sel][:, None]
            entry = (start[sel] - inc + cc[sel]).gather(1, cell) + slot
            entry = torch.where(real, entry, torch.zeros_like(entry))
            mask = real & (etype[entry] == ptype_q[sel][:, None])
            first = table.sorted_part[torch.clamp(
                start[sel][:, 0], 0, table.sorted_part.shape[0] - 1)]
            yield Block(sel, entry, real, mask, first)

    return blocks(), torch.cat(need), torch.cat(clip), tot


def knn_radius_plain(table: NeighborTable, pos_q, ptype_q, h_guess, k: int,
                     *, cap: int, n_iter: int = 3,
                     boundary_pad: float = 1.0001,
                     keys: Optional[list] = None) -> Knn:
    """Plain PyTorch version of ``knn_radius`` (``keys``: a list that
    receives each iteration's deduplicated bucket keys, for
    ``bounds.knn_work``)."""
    n, dev = pos_q.shape[0], pos_q.device
    etype = entry_types(table)
    xyz = table.rows[:, :3].contiguous()
    h = h_guess.clone()
    need = torch.zeros(n, dtype=torch.int64, device=dev)
    clip = torch.zeros(n, dtype=torch.bool, device=dev)
    scanned = torch.zeros_like(need)
    ovf = torch.zeros_like(clip)
    cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    for it in range(n_iter):
        blocks, nd, cl, tot = candidate_blocks(table, pos_q, ptype_q, h,
                                               cap=cap, keys=keys,
                                               etype=etype)
        need = torch.maximum(need, nd)
        clip |= cl
        scanned += tot
        ovf = nd > cap
        h_new = h.clone()
        for b in blocks:
            pq = pos_q[b.sel]
            r2 = torch.where(b.mask, _r2(xyz[b.entry], pq, table.box),
                             torch.full_like(b.mask, float("inf"),
                                             dtype=pq.dtype))
            if r2.shape[1] < k:
                r2 = torch.cat([r2, torch.full(
                    (r2.shape[0], k - r2.shape[1]), float("inf"),
                    dtype=r2.dtype, device=dev)], dim=1)
            kth = torch.topk(r2, k, dim=1, largest=False).values[:, -1]
            n_cand = torch.sum(b.mask, dim=1)
            hb = torch.where(n_cand >= k,
                             torch.sqrt(torch.clamp(kth, min=0.0))
                             * boundary_pad, h[b.sel] * 2.0)
            h_new[b.sel] = hb
            if it == n_iter - 1:
                cnt[b.sel] = torch.sum((r2 < (hb * hb)[:, None])
                                       & torch.isfinite(r2),
                                       dim=1).to(torch.int32)
        h = h_new
    return Knn(h, cnt, ovf, need.to(torch.int32), clip, scanned)


def knn_radius(table: NeighborTable, pos_q, ptype_q, h_guess, k: int, *,
               cap: int, n_iter: int = 3,
               boundary_pad: float = 1.0001) -> Knn:
    """Radius enclosing exactly k same-type particles (self included): the
    fixed point h <- (k-th smallest r among the level's stencil
    candidates) x boundary_pad, or 2 h when fewer than k, ``n_iter``
    times; the count at the final h over the last iteration's candidates.
    On a CUDA tensor one launch of ``csrc/hash_knn.cu`` (a warp a query,
    every iteration), h and the counts bit-equal to the plain version."""
    if not pos_q.is_cuda:
        return knn_radius_plain(table, pos_q, ptype_q, h_guess, k, cap=cap,
                                n_iter=n_iter, boundary_pad=boundary_pad)
    if k > MAX_K or k < 1:
        raise ValueError(f"knn_radius: k = {k} outside the kernel's "
                         f"1..{MAX_K} (DesNumNgb)")
    from .._build import check_cuda, kernels_lib, launch_args
    n = pos_q.shape[0]
    LN, H = table.sorted_part.shape[0], table.n_hash
    L = table.n_levels
    check_cuda("knn_radius", rows=(table.rows, torch.float32, (LN, 8)),
               bstart=(table.bucket_start, torch.int32, (L * H,)),
               bcount=(table.bucket_count, torch.int32, (L * H,)),
               pos_q=(pos_q, torch.float32, (n, 3)),
               ptype_q=(ptype_q, torch.int32, (n,)),
               h_guess=(h_guess, torch.float32, (n,)))
    i32 = dict(dtype=torch.int32, device=pos_q.device)
    h = torch.empty(n, dtype=torch.float32, device=pos_q.device)
    cnt, ovf = torch.empty(n, **i32), torch.empty(n, **i32)
    need, clip = torch.empty(n, **i32), torch.empty(n, **i32)
    scanned = torch.empty(n, **i32)
    err = kernels_lib().hash_knn_launch(*launch_args(
        table.rows, table.bucket_start, table.bucket_count, table.geom, L, H,
        float(table.box), pos_q, ptype_q, h_guess, n, int(k), int(cap),
        int(n_iter), float(boundary_pad), h, cnt, ovf, need, clip, scanned))
    if err:
        raise RuntimeError(f"hash_knn kernel launch failed: CUDA error {err}")
    knn_radius.launches += 1
    return Knn(h, cnt, ovf.bool(), need, clip.bool(), scanned.long())


knn_radius.launches = 0


def default_cell_size(pos, valid, k: int, box: float = 0.0) -> float:
    """Base cell size heuristic (host side, as JAX computes it: float32
    extents, their product in float32)."""
    p = pos.detach().cpu().numpy()[valid.detach().cpu().numpy()]
    n = max(len(p), 1)
    if float(box) > 0:
        vol = float(box) ** 3
    else:
        ext = p.max(axis=0) - p.min(axis=0) if n > 1 else np.ones(3)
        vol = float(np.prod(np.maximum(ext, 1e-10)))
    r_k = (3.0 * k * vol / (4.0 * np.pi * n)) ** (1.0 / 3.0)
    return max(r_k / 4.0, 1e-10)


def setup_smoothing_lengths(p, des_num_ngb: int, max_dev: int, box=None,
                            cap: int = 96, return_info: bool = False):
    """Initial hsml_vd and ngb_vd of the collisionless particles
    (init.c setup_smoothinglengths_sidm -> setup_nbr_sidm, sidm.c:630-805):
    the DesNumNgb-th neighbour radius, four iterations from 2 s0. JAX
    chunks the queries on the host for its TPU backend; here they are one
    launch. Returns the particles (with ``return_info`` also the Knn)."""
    import dataclasses

    boxv = 0.0 if box is None else float(box)
    s0 = default_cell_size(p.pos, p.valid, des_num_ngb, boxv)
    table = build_table(p.pos, p.ptype, p.valid, s0=s0, box=boxv)
    h0 = torch.full((p.pos.shape[0],), 2.0 * s0, dtype=p.pos.dtype,
                    device=p.pos.device)
    r = knn_radius(table, p.pos, p.ptype, h0, des_num_ngb, cap=cap, n_iter=4)
    col = p.is_collisionless
    q = dataclasses.replace(
        p, hsml_vd=torch.where(col, r.h.to(p.pos.dtype), p.hsml_vd),
        ngb_vd=torch.where(col, r.cnt, p.ngb_vd).to(torch.int32))
    return (q, r) if return_info else q
