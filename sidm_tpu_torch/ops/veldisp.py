"""Local velocity dispersion and DM density for timestep criteria 2-4
(``VelDispOn``; port of ``sidm_tpu/ops/veldisp.py:26-97``, veldisp.c:17-257).

For each active collisionless particle, over its same-type neighbours
within hsml_vd (itself included), on the hash grid of ``ops/neighbors.py``:

    hsml_vd     = the DesNumNgb-th neighbour radius (``knn_radius``, three
                  iterations from the current hsml_vd, 2 s0 where none)
    ngb_vd      = the neighbours with r < hsml_vd
    DensVelDisp = sum_j m_j W(r/h)/h^3
    VelDisp     = sqrt( sum_k [ <v_k^2> - <v_k>^2 ] )   (unweighted means)

with the table built at the predicted positions and velocities, base cell
size the smallest current hsml_vd (``sidm.base_cell``) and the
neighbours read from the 27 stencil buckets of the level of the converged
h, up to ``cap`` rows a bucket, as JAX's ``gather_candidates`` reads them.

The sums are kernel H4 (``csrc/hash_veldisp.cu``, a warp a query) on a
CUDA tensor and ``veldisp_sums_plain`` on a CPU one. Both sum m W, v and
v^2 in float64: ``<v^2> - <v>^2`` cancels in float32, which is where
JAX's float32 sums differ from them. The counts are JAX's exactly.

What JAX discards is counted: ``need`` (the largest bucket count a query
reached, > cap: rows dropped) and ``lvl_clip`` (queries whose level was
clipped to the grid's last, so that their stencil misses part of their
ball). JAX reads at most 96 rows a bucket on a 10-level grid; ``Simulation``
grows both to the demand. Only the updated particles are queried (JAX
queries all and discards the others' results).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..kernels import sph_kernel
from .neighbors import (NeighborTable, _r2, build_table, candidate_blocks,
                        knn_radius, knn_radius_plain, make_payload)
from .sidm import base_cell


class VdSums(NamedTuple):
    """The neighbour sums of each query: ``cnt`` (same type, r < h), ``rho``
    = sum m W(r/h)/h^3, ``sv`` (n, 3) = sum v, ``sv2`` = sum |v|^2 (all
    float64), and the stencil's ``need``, ``clip`` and rows read
    (``scanned``)."""
    cnt: torch.Tensor
    rho: torch.Tensor
    sv: torch.Tensor
    sv2: torch.Tensor
    need: torch.Tensor
    clip: torch.Tensor
    scanned: torch.Tensor


def veldisp_sums_plain(table: NeighborTable, pos_q, ptype_q, h, *, cap: int,
                       keys: Optional[list] = None) -> VdSums:
    """Plain PyTorch version of ``veldisp_sums``, on the compact layout
    (``candidate_blocks``). ``keys``: a list that receives the
    deduplicated bucket keys (for ``bounds.veldisp_work``)."""
    n, dev = pos_q.shape[0], pos_q.device
    f64 = dict(dtype=torch.float64, device=dev)
    cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    rho, sv2 = torch.zeros(n, **f64), torch.zeros(n, **f64)
    sv = torch.zeros(n, 3, **f64)
    blocks, need, clip, tot = candidate_blocks(table, pos_q, ptype_q, h,
                                               cap=cap, keys=keys)
    for b in blocks:
        rows = table.rows[b.entry]
        r = torch.sqrt(_r2(rows, pos_q[b.sel], table.box))
        hb = torch.clamp(h[b.sel], min=1e-30)[:, None]
        ok = b.mask & (r < hb)
        wk = sph_kernel(r / hb) / (hb * hb * hb)
        rho[b.sel] = torch.sum(torch.where(ok, rows[..., 6] * wk,
                                           torch.zeros_like(wk)).double(), 1)
        v = torch.where(ok[..., None], rows[..., 3:6],
                        torch.zeros_like(rows[..., 3:6])).double()
        sv[b.sel] = torch.sum(v, 1)
        sv2[b.sel] = torch.sum(v * v, (1, 2))
        cnt[b.sel] = torch.sum(ok, 1).to(torch.int32)
    return VdSums(cnt, rho, sv, sv2, need.to(torch.int32), clip, tot)


def veldisp_sums(table: NeighborTable, pos_q, ptype_q, h, *,
                 cap: int) -> VdSums:
    """The neighbour sums of the queries at radius h: the same-type rows of
    the 27 stencil buckets of h's level, up to ``cap`` a bucket, with r < h.
    On a CUDA tensor one launch of ``csrc/hash_veldisp.cu`` (a warp a
    query): counts, need, clip and rows read equal to the plain version's,
    the float64 sums in another order."""
    if not pos_q.is_cuda:
        return veldisp_sums_plain(table, pos_q, ptype_q, h, cap=cap)
    from .._build import check_cuda, kernels_lib, launch_args
    n = pos_q.shape[0]
    LN, H = table.sorted_part.shape[0], table.n_hash
    L = table.n_levels
    check_cuda("veldisp_sums", rows=(table.rows, torch.float32, (LN, 8)),
               bstart=(table.bucket_start, torch.int32, (L * H,)),
               bcount=(table.bucket_count, torch.int32, (L * H,)),
               pos_q=(pos_q, torch.float32, (n, 3)),
               ptype_q=(ptype_q, torch.int32, (n,)),
               h=(h, torch.float32, (n,)))
    dev = pos_q.device
    i32, f64 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.float64,
                                                         device=dev)
    cnt, need = torch.empty(n, **i32), torch.empty(n, **i32)
    clip, scanned = torch.empty(n, **i32), torch.empty(n, **i32)
    rho, sv2, sv = (torch.empty(n, **f64), torch.empty(n, **f64),
                    torch.empty(n, 3, **f64))
    if n == 0:
        return VdSums(cnt, rho, sv, sv2, need, clip.bool(), scanned.long())
    err = kernels_lib().hash_veldisp_launch(*launch_args(
        table.rows, table.bucket_start, table.bucket_count, table.geom, L, H,
        float(table.box), pos_q, ptype_q, h, n, int(cap), cnt, rho, sv, sv2,
        need, clip, scanned))
    if err:
        raise RuntimeError(f"hash_veldisp kernel launch failed: CUDA error "
                           f"{err}")
    veldisp_sums.launches += 1
    return VdSums(cnt, rho, sv, sv2, need, clip.bool(), scanned.long())


veldisp_sums.launches = 0


def moments(s: VdSums, dtype):
    """(dens_vd, vel_disp) from the sums: rho, and sqrt(max(sum_k <v_k^2> -
    <v_k>^2, 0)) with means over max(cnt, 1) neighbours, in float64."""
    ngb = torch.clamp(s.cnt, min=1).double()
    vmean = s.sv / ngb[:, None]
    disp2 = s.sv2 / ngb - torch.sum(vmean * vmean, 1)
    return (s.rho.to(dtype),
            torch.sqrt(torch.clamp(disp2, min=0.0)).to(dtype))


def _veldisp(p, pos_pred, vel_pred, active, des_num_ngb: int, box: float,
             cap: int, n_levels: int, plain: bool):
    dtype, dev = pos_pred.dtype, pos_pred.device
    s0 = base_cell(p, pos_pred, des_num_ngb, box)
    table = build_table(pos_pred, p.ptype, p.valid, s0=s0, box=box,
                        n_levels=n_levels,
                        payload=make_payload(pos_pred, vel_pred, p.mass,
                                             p.ptype))
    sel = torch.nonzero(p.is_collisionless & active).flatten()
    z = torch.zeros((), dtype=torch.int64, device=dev)
    info = dict(need=z, ngb_ovf=z, lvl_clip=z, queries=int(sel.numel()),
                table=table, sel=sel, knn=None, sums=None,
                rows=torch.zeros(1, dtype=torch.int64, device=dev),
                h_max=torch.zeros((), dtype=dtype, device=dev))
    if sel.numel() == 0:
        return p, info
    pq = pos_pred[sel].contiguous()
    tq = p.ptype[sel].contiguous()
    warm = torch.where(p.hsml_vd > 0, p.hsml_vd, 2.0 * s0)[sel].contiguous()
    knn_fn = knn_radius_plain if plain else knn_radius
    sums_fn = veldisp_sums_plain if plain else veldisp_sums
    knn = knn_fn(table, pq, tq, warm, des_num_ngb, cap=cap, n_iter=3)
    s = sums_fn(table, pq, tq, knn.h.contiguous(), cap=cap)
    rho, disp = moments(s, dtype)

    def put(field, values):
        out = field.clone()
        out[sel] = values.to(field.dtype)
        return out

    q = dataclasses.replace(
        p, hsml_vd=put(p.hsml_vd, knn.h), ngb_vd=put(p.ngb_vd, s.cnt),
        dens_vd=put(p.dens_vd, rho), vel_disp=put(p.vel_disp, disp))
    need = torch.maximum(knn.need, s.need)
    info.update(need=torch.max(need).long(),
                ngb_ovf=torch.sum(need > cap),
                lvl_clip=torch.sum(knn.clip | s.clip), knn=knn, sums=s,
                rows=knn.scanned + s.scanned, h_max=torch.max(knn.h))
    return q, info


def veldisp(p, pos_pred, vel_pred, active, *, des_num_ngb: int,
            box: float = 0.0, cap: int = 96, n_levels: int = 10):
    """One velocity-dispersion pass (JAX's ``veldisp``): particles with
    hsml_vd, ngb_vd, dens_vd and vel_disp updated where collisionless and
    active, and an info dict: ``need`` (the largest bucket count a query
    reached), ``ngb_ovf`` (queries that read a bucket past ``cap``),
    ``lvl_clip`` (queries whose level was clipped), ``queries``, ``rows``
    (rows read a query, H1's iterations and H4's), ``h_max`` (the largest
    radius), and the ``table``,
    ``sel`` (the queried particles), ``knn`` and ``sums`` results. Kernels
    H1 and H4 on CUDA tensors."""
    return _veldisp(p, pos_pred, vel_pred, active, des_num_ngb, float(box),
                    int(cap), int(n_levels), plain=False)


def veldisp_plain(p, pos_pred, vel_pred, active, *, des_num_ngb: int,
                  box: float = 0.0, cap: int = 96, n_levels: int = 10):
    """``veldisp`` on the plain versions of H1 and H4, on any device."""
    return _veldisp(p, pos_pred, vel_pred, active, des_num_ngb, float(box),
                    int(cap), int(n_levels), plain=True)
