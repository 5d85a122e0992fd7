"""SPH on the hash grid: the density pass and the hydrodynamic force
(port of ``sidm_tpu/ops/sph.py``: ``SphParams`` :42, ``sph_density`` :69,
``hydro_force`` :182; density.c:21-354, hydra.c:16-441).

``sph_density``: the smoothing lengths of the active gas are refreshed to
the DesNumNgb-th gas neighbour radius (``knn_radius``, kernel H1, three
iterations from the current hsml, or from ``r_k``, the mean gas spacing
over the bounding box of all valid particles, where none is set), clamped
to ``min_gas_hsml``; then over the gas rows of the 27 stencil buckets of
the new h's level, up to ``cap`` a bucket, with r < h (the minimum image in
a periodic box):

    rho  = sum m W(r/h)/h^3                      (self included)
    divv = -sum m dW(r/h)/h^4 / r (d . dv)        (r > 0)
    rot  =  sum m dW(r/h)/h^4 / r (d x dv)        (r > 0)

with d = x_q - x_j, dv = v_q - v_j; div v = divv/rho, curl v = |rot|/rho,
DtDensity = -divv (comoving -divv/(H(a) a^1.5)) and DtHsml with the
DesNumNgb drift correction and the -0.9/dt floors (density.c:304-325). The
table is built on the predicted positions with base cell size half the
smallest warm h over all gas (``sph.py:79-94``). The sums are kernel H5
(``csrc/hash_sph.cu`` ``sph_density_launch``) on a CUDA tensor and
``sph_density_sums_plain`` on a CPU one.

``hydro_force``: the symmetrised pressure force m_j (2 sqrt(P_i P_j) /
(rho_i rho_j) + visc) 0.5 (dW_i + dW_j) with Monaghan viscosity, the
Balsara switch and the viscosity limiter (hydra.c:275-342), over a
12-column payload [pos3 vel3 mass aux h rho csnd f_balsara] (aux = type
+ 8 active) re-attached to the density's table. Every valid gas particle
q, active or not, queries its own radius h_q: each (q, c) pair with c != q
and r < h_q carries the dW(h_q) half of the kernel, GATHERED into q where q
is active and SCATTERED into c with q's mass where c is active; together
the halves cover r < max(h_q, h_c). The pair terms are kernel H6
(``csrc/hash_sph.cu`` ``sph_hydro_launch``: the scatter an atomic add on
float64 accumulators) on a CUDA tensor and ``hydro_pairs_plain`` on a CPU
one.

Both kernels evaluate each pair's float32 terms in the plain versions'
order (built with ``-fmad=false``) and sum them in float64, rounded once
to the state's dtype: the counts, ``need``, ``clip`` and rows read are the
plain versions' exactly, the sums equal up to their order. JAX sums the
same float32 terms in float32.

What JAX discards is counted, as in ``ops/veldisp.py``: ``need`` (the
largest bucket count a query reached, > cap: rows dropped) and
``lvl_clip`` (queries whose level was clipped to the grid's last).
JAX reads at most 96 rows a bucket on a 10-level grid; ``grown_pass``
(``Simulation``'s SPH pass) grows both to the demand. JAX's ``SphParams.block`` (its query blocking)
has no counterpart here: each pass is one launch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..constants import GAMMA, GAMMA_MINUS1
from ..cosmo import hubble_of_a, s_of_a
from ..kernels import sph_kernel, sph_kernel_deriv
from .neighbors import (NeighborTable, build_table, candidate_blocks,
                        grown_cap, grown_levels, knn_radius,
                        knn_radius_plain, make_payload, min_image,
                        with_payload)

WIDE_DIM = 12           # the hydro payload's columns


class SphParams(NamedTuple):
    des_num_ngb: int
    max_num_ngb_dev: int
    art_bulk_visc: float
    min_egy_spec: float
    min_gas_hsml: float
    comoving: bool
    hubble: float
    omega0: float
    omega_lambda: float
    cap: int = 96


class SphPass(NamedTuple):
    """``grown_pass``'s result: the particles with the density fields set
    (``p``), the hydro ``acc`` and ``dt_egy``, the last pass's ``dinfo``
    and ``hinfo``, the ``cap`` and ``levels`` the next pass starts from,
    the passes made (``tries``) and the last pass's numbers (``stats``:
    need, ngb_ovf, lvl_clip, rows_mean, rows_max, hydro_rows_mean)."""
    p: object
    acc: torch.Tensor
    dt_egy: torch.Tensor
    dinfo: dict
    hinfo: dict
    cap: int
    levels: int
    tries: int
    stats: dict


class DensSums(NamedTuple):
    """H5's result per query: ``cnt`` (gas rows with r < h), float64
    ``rho``, ``divv``, ``rot`` (n, 3), and the stencil's ``need``,
    ``clip`` and rows read (``scanned``)."""
    cnt: torch.Tensor
    rho: torch.Tensor
    divv: torch.Tensor
    rot: torch.Tensor
    need: torch.Tensor
    clip: torch.Tensor
    scanned: torch.Tensor


class PairFactors(NamedTuple):
    """The hydro pair terms' scalars, float32 values as JAX computes them
    at the step's time (``sph.py:207-221``)."""
    art_bulk_visc: float
    comoving: bool
    sqrt_a: float
    hubble_a: float
    time: float
    prefac: float
    fac_visc_fix: float
    egy_fac: float


class HydroSums(NamedTuple):
    """H6's result: float64 ``acc`` (N, 3) and ``dt_egy`` (N,), both
    halves added; per query ``pairs`` (its (q, c) pairs), ``need``,
    ``clip`` and rows read (``scanned``)."""
    acc: torch.Tensor
    dt_egy: torch.Tensor
    pairs: torch.Tensor
    need: torch.Tensor
    clip: torch.Tensor
    scanned: torch.Tensor


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def sph_density_sums_plain(table: NeighborTable, pos_q, vel_q, ptype_q, h, *,
                           cap: int, keys: Optional[list] = None) -> DensSums:
    """Plain PyTorch version of ``sph_density_sums``, on the compact layout
    (``candidate_blocks``). ``keys``: a list that receives the
    deduplicated bucket keys (for ``bounds.sph_density_work``)."""
    n, dev = pos_q.shape[0], pos_q.device
    f64 = dict(dtype=torch.float64, device=dev)
    cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    rho, divv = torch.zeros(n, **f64), torch.zeros(n, **f64)
    rot = torch.zeros(n, 3, **f64)
    blocks, need, clip, tot = candidate_blocks(table, pos_q, ptype_q, h,
                                               cap=cap, keys=keys)
    for b in blocks:
        rows = table.rows[b.entry]
        s = b.sel
        d = [min_image(pos_q[s, k, None] - rows[..., k], table.box)
             for k in range(3)]
        dv = [vel_q[s, k, None] - rows[..., 3 + k] for k in range(3)]
        r = torch.sqrt(_dot(d, d))
        hb = torch.clamp(h[s], min=1e-30)[:, None]
        ok = b.mask & (r < hb)
        u = r / hb
        hinv3 = 1.0 / (hb * hb * hb)
        hinv4 = hinv3 / hb
        zero = torch.zeros_like(r)
        mj = rows[..., 6]
        wk = torch.where(ok, sph_kernel(u) * hinv3, zero)
        dwk = torch.where(ok, sph_kernel_deriv(u) * hinv4, zero)
        rho[s] = torch.sum((mj * wk).double(), 1)
        fac = torch.where(ok & (r > 0),
                          mj * dwk / torch.clamp(r, min=1e-30), zero)
        divv[s] = -torch.sum((fac * _dot(d, dv)).double(), 1)
        cross = (d[1] * dv[2] - d[2] * dv[1], d[2] * dv[0] - d[0] * dv[2],
                 d[0] * dv[1] - d[1] * dv[0])
        rot[s] = torch.stack([torch.sum((fac * c).double(), 1)
                              for c in cross], 1)
        cnt[s] = torch.sum(ok, 1).to(torch.int32)
    return DensSums(cnt, rho, divv, rot, need.to(torch.int32), clip, tot)


def sph_density_sums(table: NeighborTable, pos_q, vel_q, ptype_q, h, *,
                     cap: int) -> DensSums:
    """The density sums of the queries at radius h over the rows of their
    type in the 27 stencil buckets of h's level, up to ``cap`` a bucket,
    with r < h. On a CUDA tensor one launch of kernel H5
    (``csrc/hash_sph.cu``, a warp a query): counts, need, clip and rows
    read equal to the plain version's, the float64 sums in another
    order."""
    if not pos_q.is_cuda:
        return sph_density_sums_plain(table, pos_q, vel_q, ptype_q, h,
                                      cap=cap)
    from .._build import check_cuda, kernels_lib, launch_args
    n = pos_q.shape[0]
    LN, H = table.sorted_part.shape[0], table.n_hash
    L = table.n_levels
    check_cuda("sph_density_sums",
               rows=(table.rows, torch.float32, (LN, 8)),
               bstart=(table.bucket_start, torch.int32, (L * H,)),
               bcount=(table.bucket_count, torch.int32, (L * H,)),
               pos_q=(pos_q, torch.float32, (n, 3)),
               vel_q=(vel_q, torch.float32, (n, 3)),
               ptype_q=(ptype_q, torch.int32, (n,)),
               h=(h, torch.float32, (n,)))
    dev = pos_q.device
    i32 = dict(dtype=torch.int32, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    cnt, need = torch.empty(n, **i32), torch.empty(n, **i32)
    clip, scanned = torch.empty(n, **i32), torch.empty(n, **i32)
    rho, divv = torch.empty(n, **f64), torch.empty(n, **f64)
    rot = torch.empty(n, 3, **f64)
    if n == 0:
        return DensSums(cnt, rho, divv, rot, need, clip.bool(),
                        scanned.long())
    err = kernels_lib().sph_density_launch(*launch_args(
        table.rows, table.bucket_start, table.bucket_count, table.geom, L, H,
        float(table.box), pos_q, vel_q, ptype_q, h, n, int(cap), cnt, rho,
        divv, rot, need, clip, scanned))
    if err:
        raise RuntimeError(f"sph_density kernel launch failed: CUDA error "
                           f"{err}")
    sph_density_sums.launches += 1
    return DensSums(cnt, rho, divv, rot, need, clip.bool(), scanned.long())


sph_density_sums.launches = 0


def hydro_pairs_plain(table: NeighborTable, pos_q, vel_q, ptype_q, h_q,
                      idx_q, qv, n: int, f: PairFactors, *, cap: int,
                      keys: Optional[list] = None) -> HydroSums:
    """Plain PyTorch version of ``hydro_pairs``, on the compact layout
    (``candidate_blocks``); the gather and scatter halves summed in
    float64 by ``index_add_``."""
    nq, dev = pos_q.shape[0], pos_q.device
    acc = torch.zeros(n, 3, dtype=torch.float64, device=dev)
    de = torch.zeros(n, dtype=torch.float64, device=dev)
    pairs = torch.zeros(nq, dtype=torch.int32, device=dev)
    blocks, need, clip, tot = candidate_blocks(table, pos_q, ptype_q, h_q,
                                               cap=cap, keys=keys)
    alpha = f.art_bulk_visc
    for b in blocks:
        rows = table.rows[b.entry]
        cidx = table.sorted_part[b.entry].long()
        s = b.sel
        iq = idx_q[s].long()
        rho_q, csnd_q, fb_q, m_q, por2_q, dt_q, act_q = (
            qv[s, k, None] for k in range(7))
        d = [min_image(pos_q[s, k, None] - rows[..., k], table.box)
             for k in range(3)]
        dv = [vel_q[s, k, None] - rows[..., 3 + k] for k in range(3)]
        r2 = _dot(d, d)
        r = torch.sqrt(r2)
        hq = h_q[s][:, None]
        hb = torch.clamp(hq, min=1e-30)
        ok = b.mask & (r < hb) & (cidx != iq[:, None])
        zero = torch.zeros_like(r)
        h2 = hb * hb
        dwk = torch.where(ok, sph_kernel_deriv(r / hb) / (h2 * h2), zero)
        vdotr2 = _dot(d, dv)
        if f.comoving:
            # a 0-d tensor: PyTorch's CUDA division by a Python number is a
            # product with its reciprocal, one rounding off the kernel's
            sqrt_a = torch.tensor(f.sqrt_a, dtype=r2.dtype, device=dev)
            vdotr2 = vdotr2 / sqrt_a + f.hubble_a * r2
        h_ij = 0.5 * (hq + rows[..., 8])
        c_ij = 0.5 * (csnd_q + rows[..., 10])
        rho_ij = 0.5 * (rho_q + rows[..., 9])
        mu = h_ij * vdotr2 / (r2 + 0.01 * h_ij * h_ij)
        if f.comoving:
            mu = mu * f.time
        app = vdotr2 < 0
        visc = torch.where(
            app, (-alpha * mu * c_ij + 2.0 * alpha * mu * mu)
            / torch.clamp(rho_ij, min=1e-30) * 0.5 * (fb_q + rows[..., 11]),
            zero)
        msum = 0.5 * (m_q + rows[..., 6])
        lim = f.fac_visc_fix * vdotr2 / (
            msum * (2.0 * dwk) * torch.clamp(r, min=1e-30)
            * torch.clamp(dt_q, min=1e-30))
        visc = torch.where(app & (dt_q > 0) & (dwk < 0),
                           torch.minimum(visc, lim), visc)
        rho_c = torch.clamp(rows[..., 9], min=1e-30)
        por2_c = rows[..., 10] * rows[..., 10] / (GAMMA * rho_c)
        pp = 2.0 * torch.sqrt(torch.clamp(por2_q * por2_c, min=0.0))
        r_safe = torch.clamp(r, min=1e-30)
        half = f.prefac * 0.5
        half_egy = 0.5 * f.egy_fac
        hfc = half * rows[..., 6] * (pp + visc) * dwk / r_safe
        hfc_c = half * m_q * (pp + visc) * dwk / r_safe
        gat = ok & (act_q > 0)
        sca = ok & (rows[..., 7] >= 8.0)
        hg = torch.where(gat, hfc, zero)
        hs = torch.where(sca, hfc_c, zero)
        acc.index_add_(0, iq, -torch.stack(
            [torch.sum((hg * dk).double(), 1) for dk in d], 1))
        de.index_add_(0, iq, torch.sum((half_egy * hg * vdotr2).double(), 1))
        flat = cidx.reshape(-1)
        acc.index_add_(0, flat, torch.stack(
            [(hs * dk).double().reshape(-1) for dk in d], 1))
        de.index_add_(0, flat, (half_egy * hs * vdotr2).double().reshape(-1))
        pairs[s] = torch.sum(ok, 1).to(torch.int32)
    return HydroSums(acc, de, pairs, need.to(torch.int32), clip, tot)


def hydro_pairs(table: NeighborTable, pos_q, vel_q, ptype_q, h_q, idx_q, qv,
                n: int, f: PairFactors, *, cap: int) -> HydroSums:
    """The hydro pair terms of the queries (particles ``idx_q`` at radius
    ``h_q``; ``qv`` (nq, 8) float32 [rho, csnd, f_balsara, mass,
    P/rho^2, dt, active, 0]) on the wide table (``WIDE_DIM`` columns): for
    each row of the query's type in the 27 stencil buckets of h_q's level,
    up to ``cap`` a bucket, that is another particle at r < h_q, the
    dW(h_q) half gathered into the query where it is active and scattered
    into the row's particle where that is active, into float64 (n, 3) and
    (n,) accumulators. On a CUDA tensor one launch of kernel H6
    (``csrc/hash_sph.cu``, a warp a query, the scatter by atomic adds):
    pairs, need, clip and rows read equal to the plain version's, the
    sums in another order."""
    if not pos_q.is_cuda:
        return hydro_pairs_plain(table, pos_q, vel_q, ptype_q, h_q, idx_q,
                                 qv, n, f, cap=cap)
    from .._build import check_cuda, kernels_lib, launch_args
    nq = pos_q.shape[0]
    LN, H = table.sorted_part.shape[0], table.n_hash
    L = table.n_levels
    check_cuda("hydro_pairs",
               rows=(table.rows, torch.float32, (LN, WIDE_DIM)),
               part=(table.sorted_part, torch.int32, (LN,)),
               bstart=(table.bucket_start, torch.int32, (L * H,)),
               bcount=(table.bucket_count, torch.int32, (L * H,)),
               pos_q=(pos_q, torch.float32, (nq, 3)),
               vel_q=(vel_q, torch.float32, (nq, 3)),
               ptype_q=(ptype_q, torch.int32, (nq,)),
               h_q=(h_q, torch.float32, (nq,)),
               idx_q=(idx_q, torch.int32, (nq,)),
               qv=(qv, torch.float32, (nq, 8)))
    dev = pos_q.device
    i32 = dict(dtype=torch.int32, device=dev)
    acc = torch.zeros(n, 3, dtype=torch.float64, device=dev)
    de = torch.zeros(n, dtype=torch.float64, device=dev)
    pairs, need = torch.empty(nq, **i32), torch.empty(nq, **i32)
    clip, scanned = torch.empty(nq, **i32), torch.empty(nq, **i32)
    if nq == 0:
        return HydroSums(acc, de, pairs, need, clip.bool(), scanned.long())
    err = kernels_lib().sph_hydro_launch(*launch_args(
        table.rows, table.sorted_part, table.bucket_start,
        table.bucket_count, table.geom, L, H, float(table.box), pos_q, vel_q,
        ptype_q, h_q, idx_q, qv, nq, int(cap), float(f.art_bulk_visc),
        float(2.0 * f.art_bulk_visc), int(f.comoving), float(f.sqrt_a),
        float(f.hubble_a), float(f.time), float(f.prefac),
        float(f.fac_visc_fix), float(f.egy_fac), acc, de, pairs, need, clip,
        scanned))
    if err:
        raise RuntimeError(f"sph_hydro kernel launch failed: CUDA error "
                           f"{err}")
    hydro_pairs.launches += 1
    return HydroSums(acc, de, pairs, need, clip.bool(), scanned.long())


hydro_pairs.launches = 0


def _put(field, sel, values):
    out = field.clone()
    out[sel] = values.to(field.dtype)
    return out


def _sph_density(p, pos_pred, vel_pred, time, active, params: SphParams,
                 box: float, cap: int, n_levels: int, plain: bool):
    dtype, dev = pos_pred.dtype, pos_pred.device
    time = torch.as_tensor(time, dtype=dtype, device=dev)
    is_gas = p.is_gas
    ngas = torch.clamp(torch.sum(is_gas), min=1)
    if box:
        vol = torch.tensor(float(box), dtype=dtype, device=dev) ** 3
    else:
        inf = torch.full_like(pos_pred, float("inf"))
        valid = p.valid[:, None]
        ext = (torch.max(torch.where(valid, pos_pred, -inf), 0).values
               - torch.min(torch.where(valid, pos_pred, inf), 0).values)
        vol = torch.prod(torch.clamp(ext, min=1e-10))
    r_k = ((3.0 * params.des_num_ngb * vol / (4.0 * torch.pi * ngas))
           ** (1.0 / 3.0)).to(dtype)
    hwarm = torch.where(p.hsml > 0, p.hsml, r_k)
    hmin = torch.min(torch.where(is_gas, hwarm,
                                 torch.full_like(hwarm, float("inf"))))
    s0 = torch.where(torch.isfinite(hmin), torch.clamp(hmin / 2, min=1e-12),
                     r_k / 2)
    table = build_table(pos_pred, p.ptype, p.valid, s0=s0, box=box,
                        n_levels=n_levels,
                        payload=make_payload(pos_pred, vel_pred, p.mass,
                                             p.ptype))
    sel = torch.nonzero(is_gas & active).flatten()
    z = torch.zeros((), dtype=torch.int64, device=dev)
    info = dict(need=z, ngb_ovf=z, lvl_clip=z, queries=int(sel.numel()),
                table=table, sel=sel, knn=None, sums=None,
                rows=torch.zeros(1, dtype=torch.int64, device=dev),
                h_max=torch.zeros((), dtype=dtype, device=dev))
    if sel.numel() == 0:
        return p, info
    pq = pos_pred[sel].contiguous()
    vq = vel_pred[sel].contiguous()
    tq = p.ptype[sel].contiguous()
    knn_fn = knn_radius_plain if plain else knn_radius
    sums_fn = sph_density_sums_plain if plain else sph_density_sums
    warm = hwarm[sel].contiguous()
    knn = knn_fn(table, pq, tq, warm, params.des_num_ngb, cap=cap, n_iter=3)
    hsml = torch.clamp(knn.h, min=params.min_gas_hsml).contiguous()
    s = sums_fn(table, pq, vq, tq, hsml, cap=cap)
    rho, divv, rot = s.rho.to(dtype), s.divv.to(dtype), s.rot.to(dtype)
    rho_safe = torch.clamp(rho, min=1e-30)
    curl = torch.sqrt(_dot(rot.unbind(1), rot.unbind(1))) / rho_safe
    div_over_rho = divv / rho_safe
    if params.comoving:
        hubble_a = hubble_of_a(time, params.hubble, params.omega0,
                               params.omega_lambda)
        prefac = 1.0 / (hubble_a * time ** 1.5)
        dt_density = -prefac * divv
        dt_hsml = -hsml * dt_density / (3.0 * rho_safe)
    else:
        dt_density = -divv
        dt_hsml = hsml * div_over_rho / 3.0
    # the DesNumNgb drift correction and the floors (density.c:304-325)
    dt_step = 2.0 * (time - p.current_time[sel])
    ngb = knn.cnt
    ngb_safe = torch.clamp(ngb, min=1)
    corr = hsml / (2.0 * torch.clamp(dt_step, min=1e-30)) * (
        (params.des_num_ngb / ngb_safe).to(dtype) ** (1.0 / 3.0) - 1.0)
    pos_dt = dt_step > 0
    dt_hsml = torch.where(pos_dt, dt_hsml + corr, dt_hsml)
    dt_density = torch.where(
        pos_dt, torch.maximum(-0.9 * rho / dt_step, dt_density), dt_density)
    dt_hsml = torch.where(
        pos_dt, torch.maximum(-0.9 * hsml / dt_step, dt_hsml), dt_hsml)
    q = dataclasses.replace(
        p, hsml=_put(p.hsml, sel, hsml), density=_put(p.density, sel, rho),
        div_vel=_put(p.div_vel, sel, div_over_rho),
        curl_vel=_put(p.curl_vel, sel, curl),
        dt_density=_put(p.dt_density, sel, dt_density),
        dt_hsml=_put(p.dt_hsml, sel, dt_hsml),
        ngb_sph=_put(p.ngb_sph, sel, ngb))
    need = torch.maximum(knn.need, s.need)
    info.update(need=torch.max(need).long(),
                ngb_ovf=torch.sum(need > cap),
                lvl_clip=torch.sum(knn.clip | s.clip), knn=knn, sums=s,
                warm=warm,
                rows=knn.scanned + s.scanned, h_max=torch.max(knn.h))
    return q, info


def sph_density(p, pos_pred, vel_pred, time, active, params: SphParams, *,
                box: float = 0.0, cap: Optional[int] = None,
                n_levels: int = 10):
    """One density pass (JAX's ``sph_density``): particles with hsml,
    density, div_vel, curl_vel, dt_density, dt_hsml and ngb_sph updated
    where gas and active, and an info dict: ``need`` (the largest bucket
    count a query reached), ``ngb_ovf`` (queries that read a bucket past
    ``cap``), ``lvl_clip`` (queries whose level was clipped), ``queries``,
    ``rows`` (rows read a query, H1's iterations and H5's), ``h_max`` (the
    largest k-th neighbour radius), and the ``table`` (for
    ``hydro_force``), ``sel`` (the queried particles), ``warm`` (their
    radii before H1's iterations), ``knn`` and ``sums``. ``cap`` defaults to ``params.cap``. Kernels H1 and H5 on
    CUDA tensors."""
    return _sph_density(p, pos_pred, vel_pred, time, active, params,
                        float(box), int(params.cap if cap is None else cap),
                        int(n_levels), plain=False)


def sph_density_plain(p, pos_pred, vel_pred, time, active,
                      params: SphParams, *, box: float = 0.0,
                      cap: Optional[int] = None, n_levels: int = 10):
    """``sph_density`` on the plain versions of H1 and H5, on any
    device."""
    return _sph_density(p, pos_pred, vel_pred, time, active, params,
                        float(box), int(params.cap if cap is None else cap),
                        int(n_levels), plain=True)


def pair_factors(time, params: SphParams) -> PairFactors:
    """The pair terms' scalars at ``time`` (a 0-d tensor of the state's
    dtype), computed in that dtype as JAX does (``sph.py:207-221``)."""
    if not params.comoving:
        return PairFactors(float(params.art_bulk_visc), False, 1.0, 0.0,
                           float(time), 1.0, 1.0, 1.0)
    hubble_a = hubble_of_a(time, params.hubble, params.omega0,
                           params.omega_lambda)
    s_a_inv = 1.0 / s_of_a(time, params.hubble, params.omega0,
                           params.omega_lambda)
    sqrt_a = torch.sqrt(time)
    vals = torch.stack([sqrt_a, hubble_a, time, s_a_inv / time,
                        hubble_a * time ** 3, time * sqrt_a]).tolist()
    return PairFactors(float(params.art_bulk_visc), True, *vals)


def _hydro_force(p, pos_pred, vel_pred, time, active, params: SphParams,
                 table: NeighborTable, box: float, cap: int, plain: bool):
    if box != table.box:
        raise ValueError(f"hydro_force: box {box} is not the table's "
                         f"{table.box}")
    dtype, dev = pos_pred.dtype, pos_pred.device
    time = torch.as_tensor(time, dtype=dtype, device=dev)
    n = pos_pred.shape[0]
    is_gas = p.is_gas
    rho = torch.clamp(p.density, min=1e-30)
    egy = torch.clamp(p.egy_spec, min=params.min_egy_spec)
    pressure = GAMMA_MINUS1 * egy * rho
    csnd = torch.sqrt(GAMMA * pressure / rho)
    p_over_rho2 = pressure / (rho * rho)
    # +1e-30: a cold (u = 0) particle with no neighbour in range has div =
    # curl = 0, and the switch would be 0/0
    adiv = torch.abs(p.div_vel)
    f_balsara = adiv / (adiv + p.curl_vel
                        + 1e-4 * csnd / torch.clamp(p.hsml, min=1e-30)
                        + 1e-30)
    dt_step = 2.0 * (time - p.current_time)
    aux = torch.clamp(p.ptype, 0, 7).to(dtype) + 8.0 * active.to(dtype)
    wide = torch.cat([pos_pred, vel_pred, p.mass[:, None], aux[:, None],
                      p.hsml[:, None], rho[:, None], csnd[:, None],
                      f_balsara[:, None]], dim=1)
    table = with_payload(table, wide)
    sel = torch.nonzero(is_gas).flatten()
    f = pair_factors(time, params)
    qv = torch.stack([rho, csnd, f_balsara, p.mass, p_over_rho2, dt_step,
                      active.to(dtype), torch.zeros_like(rho)], 1)[sel]
    fn = hydro_pairs_plain if plain else hydro_pairs
    out = fn(table, pos_pred[sel].contiguous(), vel_pred[sel].contiguous(),
             p.ptype[sel].contiguous(), p.hsml[sel].contiguous(),
             sel.to(torch.int32), qv.contiguous(), n, f, cap=cap)
    upd = is_gas & active
    acc = torch.where(upd[:, None], out.acc.to(dtype),
                      torch.zeros_like(pos_pred))
    dt_egy = torch.where(upd, out.dt_egy.to(dtype), p.dt_egy)
    z = torch.zeros((), dtype=torch.int64, device=dev)
    info = dict(need=torch.max(out.need).long() if sel.numel() else z,
                ngb_ovf=torch.sum(out.need > cap), lvl_clip=torch.sum(
                    out.clip), queries=int(sel.numel()), rows=out.scanned,
                sel=sel, out=out, table=table, factors=f, qv=qv,
                h_max=(torch.max(p.hsml[sel]) if sel.numel()
                       else torch.zeros((), dtype=dtype, device=dev)))
    return acc, dt_egy, info


def hydro_force(p, pos_pred, vel_pred, time, active, params: SphParams,
                table: NeighborTable, *, box: float = 0.0,
                cap: Optional[int] = None):
    """Pressure and viscous accelerations and du/dt of the gas (JAX's
    ``hydro_force``) on the density pass's ``table``: (acc (N, 3), zero
    where not gas and active; dt_egy, p.dt_egy where not gas and active;
    info: ``need``, ``ngb_ovf``, ``lvl_clip``, ``queries`` (every valid
    gas particle), ``rows`` (rows read a query), ``h_max``, ``sel``,
    ``out`` (H6's HydroSums), the wide ``table``, the pair ``factors``
    and the queries' scalars ``qv``). ``box`` must be the table's. Kernel
    H6 on CUDA tensors."""
    return _hydro_force(p, pos_pred, vel_pred, time, active, params, table,
                        float(box), int(params.cap if cap is None else cap),
                        plain=False)


def hydro_force_plain(p, pos_pred, vel_pred, time, active,
                      params: SphParams, table: NeighborTable, *,
                      box: float = 0.0, cap: Optional[int] = None):
    """``hydro_force`` on the plain version of H6, on any device."""
    return _hydro_force(p, pos_pred, vel_pred, time, active, params, table,
                        float(box), int(params.cap if cap is None else cap),
                        plain=True)


def grown_pass(p, pos_pred, vel_pred, time, active, params: SphParams, *,
               box: float = 0.0, cap: int, n_levels: int, tries: int = 4,
               grow: bool = True) -> SphPass:
    """The SPH pass, ``sph_density`` then ``hydro_force`` on its table,
    with its rows per bucket and its grid's levels grown to its demand: a
    pass that read a bucket past ``cap`` or clipped a query's level (its
    stencil then misses part of its ball) is redone at ``grown_cap`` and
    ``grown_levels``, up to ``tries`` passes; the sizes also grow after
    the last pass, for the next one. ``grow`` False: one pass at ``cap``
    and ``n_levels`` (JAX's fixed 96 and 10)."""
    for k in range(1, tries + 1):
        q, dinfo = sph_density(p, pos_pred, vel_pred, time, active, params,
                               box=box, cap=cap, n_levels=n_levels)
        acc, dt_egy, hinfo = hydro_force(q, pos_pred, vel_pred, time, active,
                                         params, dinfo["table"], box=box,
                                         cap=cap)
        rows, hrows = dinfo["rows"].double(), hinfo["rows"].double()
        need, ovf, clip, ratio, rows_mean, rows_max, hrows_mean = \
            torch.stack([
                torch.maximum(dinfo["need"], hinfo["need"]).double(),
                (dinfo["ngb_ovf"] + hinfo["ngb_ovf"]).double(),
                (dinfo["lvl_clip"] + hinfo["lvl_clip"]).double(),
                torch.maximum(dinfo["h_max"], hinfo["h_max"]).double()
                / dinfo["table"].s0.double(),
                torch.mean(rows), torch.max(rows),
                torch.mean(hrows)]).tolist()
        need, ovf, clip = int(need), int(ovf), int(clip)
        sizes = ((grown_cap(cap, need), grown_levels(n_levels, clip, ratio))
                 if grow else (cap, n_levels))
        grew = sizes != (cap, n_levels)
        cap, n_levels = sizes
        if k == tries or not grew:
            break
    return SphPass(q, acc, dt_egy, dinfo, hinfo, cap, n_levels, k, dict(
        need=need, ngb_ovf=ovf, lvl_clip=clip, rows_mean=rows_mean,
        rows_max=int(rows_max), hydro_rows_mean=hrows_mean))
