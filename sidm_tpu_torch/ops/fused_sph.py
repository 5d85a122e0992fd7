"""SPH on the tree: the density pass and the hydrodynamic force over the
force phase's octree (port of ``sidm_tpu/ops/fused_sph.py``: ``_group_bbox``
:517, ``_gas_windows`` :538, ``_unsort`` :545, ``sph_density_fused`` :552,
``hydro_force_fused`` :684; the pair terms of ``_density_tile`` :231 and
``_hydro_tile`` :274; nbody/density.c:21-354, nbody/hydra.c:16-441).

The gas (smoothing length > 0) is cut into Morton windows of its own
(``fused_range.make_gated_windows``); each window's group walks the tree
with the range walk (``fused_range.range_segments``, grown to its demand by
``sized_segments``) and its targets sum over every particle of the walked
leaf segments:

* density (``tree_density_sums``, kernel T2): per target of radius h over
  the gas j with r < h, strict (self included; a slot with h = 0 passes
  nothing), rho = sum m W(r/h)/h^3, divv = -sum m dW/h^4 / r (d . dv),
  rot = sum m dW/h^4 / r (d x dv) (r > 0) and the count; the walk's pad is
  the group's largest h plus the tree's drift;
* hydro (``tree_hydro_sums``, kernel T3): per target over the pairs with
  j != i, gas j and r < max(h_i, h_j), both half-kernels gathered into the
  target, the dW(h_i) half with i's viscosity limiter and the dW(h_j) half
  with j's (scatter-free: each target sums the pair terms the reference
  accumulates for it). The walk is the hmax mode of the range walk (kernel
  T1): a cell is in range within max(pad, hmax + drift), hmax the largest
  h of the cell's particles (``range_levels(tree, hmax_sorted)``).

Smoothing lengths come from the bracketed neighbour-count controller
(``hsml_iters`` count passes, the count mode of T2) started from the
current lengths, or from the tree's cell-count seed where there are none;
then one full density pass and JAX's rate terms and floors.

What differs from JAX: the 16-particle planar ``rows16`` packing, the
``lax.map`` group blocks, the ``_w_schedule`` frontier widths of JAX's own
walk and ``sort_compact`` are TPU schedule, not ported; the port's walk is
its range walk with 64-slot windows (JAX's ``FusedConfig.group_size``), so
the sums are the same pair sums in another order. JAX's walk drops cells
past its frontier widths and caps and returns them as ``ovf``; the port's
grows its caps to the walk's demand and returns what still drops
(ROADMAP.md C.25). JAX sums float32 terms in float32; here each pair's
float32 terms are JAX's, in its order, and the sums are float64, rounded
once to the state's dtype.

Particle rows (sorted order): the density's ``[pos3 aux | vel3 mass]``
(n, 8), the hydro's ``[pos3 aux | vel3 mass | h rho csnd f_balsara | dt 0
0 0]`` (n, 16); aux is 0 for valid gas and 7 for every other particle
(JAX parks them with type 7 so that no pair passes). On a CUDA tensor the
sums are kernels T2 and T3 (``csrc/tree_sph.cu``), on a CPU tensor their
plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..constants import GAMMA, GAMMA_MINUS1
from ..cosmo import hubble_of_a, s_of_a
from ..kernels import sph_kernel, sph_kernel_deriv
from .far_kernel import S_OVF_N
from .fused_force import G, FusedConfig, min_image
from .fused_range import (make_gated_windows, range_levels,
                          segment_particles, sized_segments)
from .sph import PairFactors, SphParams

HYDRO_COLS = 16          # the hydro rows' columns
SEG_CAP = 8192           # the segment lists' first guess
TREE_SPH_PIECE = 1 << 16  # least (live slot, staged particle) pairs of one
                          # work item of T2 and T3 (csrc/tree_sph.cu)


class DensSlots(NamedTuple):
    """T2's result per group slot: float64 ``rho``, ``divv``, ``rot``
    (ng, G, 3) and the int32 neighbour count ``cnt`` (the count mode
    leaves the sums 0)."""
    rho: torch.Tensor
    divv: torch.Tensor
    rot: torch.Tensor
    cnt: torch.Tensor


class HydroSlots(NamedTuple):
    """T3's result per group slot: float64 ``acc`` (ng, G, 3) and
    ``dt_egy``, and the int32 ``pairs`` (j != i, gas, r < max(h_i,
    h_j))."""
    acc: torch.Tensor
    dt_egy: torch.Tensor
    pairs: torch.Tensor


def _live(gidx, gh):
    return (gidx >= 0) & (gh > 0)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _slots_of(keys, nn, gidx, gh, budget: int):
    """The live slots (flat ids), each slot's group's segment particles
    (sorted ids, valid) and the slots per batch."""
    slots = torch.nonzero(_live(gidx, gh).reshape(-1)).flatten()
    idx, val = segment_particles(keys, nn)
    P = max(idx.shape[1], 1)
    return slots, idx, val, max(1, budget // P)


def tree_density_sums_plain(keys, nn, rows, gt, gv, gh, gidx,
                            box: float = 0.0, count_only: bool = False,
                            budget: int = 1 << 22) -> DensSlots:
    """Plain PyTorch version of ``tree_density_sums``: JAX's
    ``_density_tile`` over each live slot's group segment particles, in
    batches of live slots, the terms summed in float64."""
    ng = gh.shape[0]
    dev, dtype = rows.device, rows.dtype
    f64 = dict(dtype=torch.float64, device=dev)
    rho, divv = torch.zeros(ng * G, **f64), torch.zeros(ng * G, **f64)
    rot = torch.zeros(ng * G, 3, **f64)
    cnt = torch.zeros(ng * G, dtype=torch.int32, device=dev)
    slots, idx_all, val_all, B = _slots_of(keys, nn, gidx, gh, budget)
    flat = [x.reshape(ng * G, *x.shape[2:]) for x in (gt, gv, gh)]
    for b0 in range(0, slots.numel(), B):
        sl = slots[b0:b0 + B]
        t, v, th = (x[sl] for x in flat)
        idx, val = idx_all[sl // G], val_all[sl // G]
        s = rows[idx]                                     # (L, P, 8)
        d = [min_image(t[:, None, c] - s[..., c], box) for c in range(3)]
        r = torch.sqrt(_dot(d, d))
        # strict r < h (unclamped): a slot with h = 0 passes nothing
        ok = val & (r < th[:, None]) & (torch.remainder(s[..., 3], 8.0) == 0)
        cnt[sl] = torch.sum(ok, dim=-1).to(torch.int32)
        if count_only:
            continue
        hb = torch.clamp(th, min=1e-30)[:, None]
        u = r / hb
        h2 = hb * hb
        zero = torch.zeros((), dtype=dtype, device=dev)
        wk = torch.where(ok, sph_kernel(u) / (h2 * hb), zero)
        dwk = torch.where(ok, sph_kernel_deriv(u) / (h2 * h2), zero)
        mj = s[..., 7]
        rho[sl] = torch.sum((mj * wk).double(), dim=-1)
        fac = torch.where(ok & (r > 0),
                          mj * dwk / torch.clamp(r, min=1e-30), zero)
        w = [v[:, None, c] - s[..., 4 + c] for c in range(3)]
        divv[sl] = -torch.sum((fac * _dot(d, w)).double(), dim=-1)
        cross = (d[1] * w[2] - d[2] * w[1], d[2] * w[0] - d[0] * w[2],
                 d[0] * w[1] - d[1] * w[0])
        rot[sl] = torch.stack([torch.sum((fac * c).double(), dim=-1)
                               for c in cross], dim=-1)
    shape = (ng, G)
    return DensSlots(rho.reshape(shape), divv.reshape(shape),
                     rot.reshape(ng, G, 3), cnt.reshape(shape))


def _items(ng: int, dev, width: int):
    from .work_items import item_cap, ws_size
    icap = item_cap(ng)
    return (icap, torch.empty(ws_size(ng, icap, False), dtype=torch.int32,
                              device=dev),
            torch.empty(icap, G, width, dtype=torch.float64, device=dev))


def tree_density_sums(keys, nn, rows, gt, gv, gh, gidx, box: float = 0.0,
                      count_only: bool = False) -> DensSlots:
    """The density sums of the group slots over their groups' walked
    segments (kernel T2; JAX's ``_density_tile`` as ``_sph_near_level``
    runs it on every level): keys (ng, L) int32 ``start*32+cnt`` with live
    counts nn (ng,); rows (n, 8) sorted ``[pos3 aux | vel3 mass]``; gt, gv
    (ng, G, 3) slot positions and velocities; gh (ng, G) radius (0: no
    target); gidx (ng, G) int32 sorted id (-1: dead slot); box > 0:
    minimum-image distances. ``count_only``: the controller's count mode
    (sums left 0; counted in ``tree_density_sums.count_launches``).

    On a CUDA tensor one launch of ``csrc/tree_sph.cu``: the groups cut
    into work items of about equal (live slot, staged particle) pairs
    (``csrc/work_items.cuh``), a block an item, the segment particles
    staged in shared memory in rounds (``csrc/seg_rounds.cuh``), each pair's
    float32 terms rounded as here, summed in float64 and folded in item
    order: the counts equal the plain version's, the sums up to their
    order."""
    if not keys.is_cuda:
        return tree_density_sums_plain(keys, nn, rows, gt, gv, gh, gidx,
                                       box, count_only)
    from .._build import check_cuda, kernels_lib, launch_args
    ng, L = keys.shape
    n = rows.shape[0]
    check_cuda("tree_density_sums", keys=(keys, torch.int32, (ng, L)),
               nn=(nn, torch.int32, (ng,)),
               rows=(rows, torch.float32, (n, 8)),
               gt=(gt, torch.float32, (ng, G, 3)),
               gv=(gv, torch.float32, (ng, G, 3)),
               gh=(gh, torch.float32, (ng, G)),
               gidx=(gidx, torch.int32, (ng, G)))
    dev = keys.device
    f64 = dict(dtype=torch.float64, device=dev)
    out = torch.empty(ng, G, 6, **f64)
    if ng:
        icap, ws, part = _items(ng, dev, 6)
        w = torch.empty(ng, dtype=torch.int32, device=dev)
        err = kernels_lib().tree_density_launch(*launch_args(
            keys, nn, ng, L, rows, gt, gv, gh, gidx, float(box),
            int(count_only), TREE_SPH_PIECE, icap, w, ws, part, out))
        if err:
            raise RuntimeError(f"tree_density kernel launch failed: CUDA "
                               f"error {err}")
        if count_only:
            tree_density_sums.count_launches += 1
        else:
            tree_density_sums.launches += 1
    return DensSlots(out[..., 0], out[..., 1], out[..., 2:5],
                     out[..., 5].to(torch.int32))


tree_density_sums.launches = 0
tree_density_sums.count_launches = 0


def tree_hydro_sums_plain(keys, nn, rows, gt, gv, gq, gidx,
                          f: PairFactors, box: float = 0.0,
                          budget: int = 1 << 21) -> HydroSlots:
    """Plain PyTorch version of ``tree_hydro_sums``: JAX's ``_hydro_tile``
    over each live slot's group segment particles, in batches of live
    slots, the terms summed in float64."""
    ng = gq.shape[0]
    dev, dtype = rows.device, rows.dtype
    f64 = dict(dtype=torch.float64, device=dev)
    acc = torch.zeros(ng * G, 3, **f64)
    de = torch.zeros(ng * G, **f64)
    pairs = torch.zeros(ng * G, dtype=torch.int32, device=dev)
    gh = gq[..., 0]
    slots, idx_all, val_all, B = _slots_of(keys, nn, gidx, gh, budget)
    flat = [x.reshape(ng * G, *x.shape[2:]) for x in (gt, gv, gq, gidx)]

    def scalar(x):
        # 0-d tensors: a CUDA division by a Python number is a product
        # with its reciprocal, one rounding off the kernel's
        return torch.tensor(x, dtype=dtype, device=dev)

    sqrt_a, hubble_a, mu_fac = (scalar(x) for x in (f.sqrt_a, f.hubble_a,
                                                    f.time))
    half = scalar(f.prefac) * 0.5
    half_egy = 0.5 * scalar(f.egy_fac)
    fvf, abv = scalar(f.fac_visc_fix), scalar(f.art_bulk_visc)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for b0 in range(0, slots.numel(), B):
        sl = slots[b0:b0 + B]
        t, v, q, ti = (x[sl] for x in flat)
        idx, val = idx_all[sl // G], val_all[sl // G]
        s = rows[idx]                                     # (L, P, 16)
        h_i, m_i, rho_i, por2_i, cs_i, fb_i, dt_i = (
            q[:, None, k] for k in range(7))
        h_j, rho_j, cs_j, fb_j = (s[..., 8 + k] for k in range(4))
        m_j, dt_j = s[..., 7], s[..., 12]
        d = [min_image(t[:, None, c] - s[..., c], box) for c in range(3)]
        r2 = _dot(d, d)
        r = torch.sqrt(r2)
        hi = torch.clamp(h_i, min=1e-30)
        hj = torch.clamp(h_j, min=1e-30)
        pair = (val & (idx != ti[:, None])
                & (torch.remainder(s[..., 3], 8.0) == 0))
        ok_i = pair & (r < hi)
        ok_j = pair & (r < hj)
        hi2, hj2 = hi * hi, hj * hj
        dwk_i = torch.where(ok_i, sph_kernel_deriv(r / hi) / (hi2 * hi2),
                            zero)
        dwk_j = torch.where(ok_j, sph_kernel_deriv(r / hj) / (hj2 * hj2),
                            zero)
        w = [v[:, None, c] - s[..., 4 + c] for c in range(3)]
        vdotr2 = _dot(d, w)
        if f.comoving:
            vdotr2 = vdotr2 / sqrt_a + hubble_a * r2
        h_ij = 0.5 * (h_i + h_j)
        c_ij = 0.5 * (cs_i + cs_j)
        rho_ij = 0.5 * (rho_i + rho_j)
        mu = h_ij * vdotr2 / (r2 + 0.01 * h_ij * h_ij)
        if f.comoving:
            mu = mu * mu_fac
        f_ij = 0.5 * (fb_i + fb_j)
        app = vdotr2 < 0
        visc = torch.where(
            app, (-abv * mu * c_ij + 2.0 * abv * mu * mu)
            / torch.clamp(rho_ij, min=1e-30) * f_ij, zero)
        msum = 0.5 * (m_i + m_j)
        r_safe = torch.clamp(r, min=1e-30)

        def limited(dwk, dt):
            lim = fvf * vdotr2 / torch.where(
                dwk < 0, msum * (2.0 * dwk) * r_safe
                * torch.clamp(dt, min=1e-30), torch.full_like(dwk, -1e30))
            return torch.where(app & (dt > 1e-30) & (dwk < 0),
                               torch.minimum(visc, lim), visc)

        visc_i, visc_j = limited(dwk_i, dt_i), limited(dwk_j, dt_j)
        p_or2_j = (cs_j * cs_j) / (GAMMA * torch.clamp(rho_j, min=1e-30))
        pp = 2.0 * torch.sqrt(torch.clamp(por2_i * p_or2_j, min=0.0))
        hfc = half * m_j * ((pp + visc_i) * dwk_i
                            + (pp + visc_j) * dwk_j) / r_safe
        acc[sl] = -torch.stack([torch.sum((hfc * dk).double(), dim=-1)
                                for dk in d], dim=-1)
        de[sl] = torch.sum((half_egy * hfc * vdotr2).double(), dim=-1)
        pairs[sl] = torch.sum(ok_i | ok_j, dim=-1).to(torch.int32)
    return HydroSlots(acc.reshape(ng, G, 3), de.reshape(ng, G),
                      pairs.reshape(ng, G))


def tree_hydro_sums(keys, nn, rows, gt, gv, gq, gidx, f: PairFactors,
                    box: float = 0.0) -> HydroSlots:
    """The hydro pair sums of the group slots over their groups' walked
    segments (kernel T3; JAX's ``_hydro_tile`` as ``_sph_near_level`` runs
    it): keys, nn as ``tree_density_sums``; rows (n, 16) sorted ``[pos3
    aux | vel3 mass | h rho csnd f_balsara | dt 0 0 0]``; gt, gv (ng, G,
    3); gq (ng, G, 8) per slot ``[h mass rho P/rho^2 csnd f_balsara dt
    0]`` (h 0: no target); gidx (ng, G) int32; f the pair factors
    (``tree_factors``; ``time`` is the comoving mu's factor). Each
    target gathers both half-kernels of each pair with another gas particle
    at r < max(h_i, h_j): no scatter, no atomics.

    On a CUDA tensor one launch of ``csrc/tree_sph.cu`` (T2's schedule):
    pairs equal to the plain version's, the float64 sums up to their
    order."""
    if not keys.is_cuda:
        return tree_hydro_sums_plain(keys, nn, rows, gt, gv, gq, gidx, f,
                                     box)
    from .._build import check_cuda, kernels_lib, launch_args
    ng, L = keys.shape
    n = rows.shape[0]
    check_cuda("tree_hydro_sums", keys=(keys, torch.int32, (ng, L)),
               nn=(nn, torch.int32, (ng,)),
               rows=(rows, torch.float32, (n, HYDRO_COLS)),
               gt=(gt, torch.float32, (ng, G, 3)),
               gv=(gv, torch.float32, (ng, G, 3)),
               gq=(gq, torch.float32, (ng, G, 8)),
               gidx=(gidx, torch.int32, (ng, G)))
    dev = keys.device
    out = torch.empty(ng, G, 5, dtype=torch.float64, device=dev)
    if ng:
        icap, ws, part = _items(ng, dev, 5)
        w = torch.empty(ng, dtype=torch.int32, device=dev)
        err = kernels_lib().tree_hydro_launch(*launch_args(
            keys, nn, ng, L, rows, gt, gv, gq, gidx, float(box),
            int(f.comoving), float(f.prefac), float(f.fac_visc_fix),
            float(f.egy_fac), float(f.sqrt_a), float(f.hubble_a),
            float(f.time), float(f.art_bulk_visc), TREE_SPH_PIECE, icap,
            w, ws, part, out))
        if err:
            raise RuntimeError(f"tree_hydro kernel launch failed: CUDA "
                               f"error {err}")
        tree_hydro_sums.launches += 1
    return HydroSlots(out[..., 0:3], out[..., 3],
                      out[..., 4].to(torch.int32))


tree_hydro_sums.launches = 0


# ------------------------------------------------------------ the drivers


def _group_bbox(gt, live_t, gh, tree, box: float):
    """Per group the bounding box of its live targets and its pad, the
    largest live h plus the tree's drift (``_group_bbox`` :517-530); a
    group without a live target is parked far outside the tree, or with a
    periodic box under an inverted huge box."""
    big = torch.full((), 1e30, dtype=gt.dtype, device=gt.device)
    glo = torch.min(torch.where(live_t[..., None], gt, big), dim=1).values
    ghi = torch.max(torch.where(live_t[..., None], gt, -big), dim=1).values
    any_v = torch.any(live_t, dim=1)[:, None]
    if box:
        glo = torch.where(any_v, glo, torch.full_like(glo, 1e18))
        ghi = torch.where(any_v, ghi, torch.full_like(ghi, -1e18))
    else:
        far_here = tree.origin + 4.0 * tree.extent
        glo = torch.where(any_v, glo, far_here)
        ghi = torch.where(any_v, ghi, far_here)
    pad = torch.max(torch.where(live_t, gh, torch.zeros_like(gh)),
                    dim=1).values + tree.drift
    return glo.contiguous(), ghi.contiguous(), pad.contiguous()


def _gas_windows(tree, h_sorted):
    """Morton windows over the gas (h_sorted > 0), ``make_gated_windows``:
    (pidx (ng, G) sorted ids, gvalid)."""
    return make_gated_windows(tree.keys_s, h_sorted, tree.pos_s.shape[0],
                              tree.depth)


def _unsort(x, gvalid, pidx, inv, n: int, fill):
    """Per-slot results (ng, G, ...) back to the original particle order
    (``fill`` where no slot holds the particle)."""
    flat = torch.where(gvalid, pidx, torch.full_like(pidx, n)).reshape(-1)
    buf = torch.full((n + 1,) + tuple(x.shape[2:]), fill, dtype=x.dtype,
                     device=x.device)
    buf[flat] = x.reshape((-1,) + tuple(x.shape[2:]))
    return buf[:n][inv]


class _Walk:
    """The range walk's sizes, grown across calls, and what it reports:
    the walks made, their drops still left after growth (cells past the
    caps ``open`` and ``big_over``, particles past the chunks
    ``big_drop``, segment list entries ``seg``) and the largest demand."""

    def __init__(self, cfg: Optional[FusedConfig], seg_cap: int):
        self.cfg = cfg or FusedConfig()
        self.seg_cap = int(seg_cap)
        self.walks = 0
        self.drops = None

    def segments(self, tree, rlev, glo, ghi, pad, box, use_hmax):
        dev = glo.device
        zero = torch.zeros((), dtype=torch.long, device=dev)
        drops = dict(open=zero, big_over=zero, big_drop=zero)
        keys, nn, _, need, stat, self.seg_cap, self.cfg = sized_segments(
            tree, rlev, glo, ghi, pad, self.seg_cap, cfg=self.cfg, box=box,
            drops=drops, use_hmax=use_hmax)
        d = torch.stack([drops["open"], drops["big_over"],
                         drops["big_drop"],
                         torch.sum(stat[S_OVF_N].long())])
        self.drops = d if self.drops is None else self.drops + d
        self.walks += 1
        return keys, nn

    def info(self) -> dict:
        d = ([0] * 4 if self.drops is None
             else [int(x) for x in self.drops.tolist()])
        return dict(walks=self.walks, seg_cap=self.seg_cap, cfg=self.cfg,
                    drops=sum(d), drops_open=d[0], drops_big_over=d[1],
                    drops_big=d[2], drops_seg=d[3])


def _sorted_inputs(p, pos_pred, vel_pred, tree):
    """(perm, inv, sorted positions, sorted velocities, sorted aux (0
    for valid gas, 7 otherwise))."""
    n = pos_pred.shape[0]
    dtype = pos_pred.dtype
    perm = tree.perm
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=perm.device)
    aux = torch.clamp(p.ptype, 0, 7).to(dtype)
    # non-gas and padding particles park with type 7 so that the gas test
    # drops them even where they share a leaf segment with gas
    aux = torch.where(p.is_gas & p.valid, aux, torch.full_like(aux, 7.0))
    return perm, inv, pos_pred[perm], vel_pred[perm], aux[perm]


def sph_density_fused(p, pos_pred, vel_pred, tree, time, active,
                      params: SphParams, cfg: Optional[FusedConfig] = None,
                      box: float = 0.0, hsml_iters: int = 4,
                      seg_cap: int = SEG_CAP, plain: bool = False,
                      on_pass=None):
    """Tree-segment ``density()`` (``sph_density_fused`` :552-681): rho,
    div v, curl v, DtDensity and DtHsml of the gas, over the range walk of
    the force phase's ``tree`` (built or refreshed on ``pos_pred``).

    The smoothing lengths are refreshed by ``hsml_iters`` rounds of the
    bracketed neighbour-count controller (ensure_neighbours' Left/Right
    bisection, density.c:382-547), each a density walk with T2's count
    mode, from the current lengths or, where there are none, the tree's
    cell-count seed (``cell_count_hsml_seed``), clamped to
    ``min_gas_hsml``; ``hsml_iters`` 0 keeps them. Then one full density
    pass. Returns (particles with hsml, density, div_vel, curl_vel,
    dt_density, dt_hsml and ngb_sph set where gas and active (hsml where
    gas), info): ``walks``, ``seg_cap`` and ``cfg`` (the walk's sizes after
    growth), ``drops`` (what the walks still dropped, by kind in
    ``drops_*``), ``passes`` (count passes + 1), ``groups``, ``targets``,
    ``pairs`` (the final pass's neighbours summed); ``cfg`` and ``seg_cap``
    are the walk's first sizes (hand the info's on to the next call).
    ``plain``: T2's plain version on any device; on_pass:
    optional observer ``on_pass(kw)`` of each T2 call's arguments."""
    from .fused_range import cell_count_hsml_seed
    n = pos_pred.shape[0]
    dtype, dev = pos_pred.dtype, pos_pred.device
    time = torch.as_tensor(time, dtype=dtype, device=dev)
    is_gas = p.is_gas
    upd = is_gas & active
    perm, inv, ps, vs, aux = _sorted_inputs(p, pos_pred, vel_pred, tree)
    rows = torch.cat([ps, aux[:, None], vs, p.mass[perm][:, None]],
                     dim=1).contiguous()

    # cold start (hsml 0): the tree's cell-count seed, else the gated
    # windows are empty and the controller stays at 0
    seed = cell_count_hsml_seed(tree, params.des_num_ngb)
    hsml = torch.where(p.hsml > 0, p.hsml, seed)
    hsml = torch.where(is_gas, torch.clamp(hsml, min=params.min_gas_hsml),
                       torch.zeros_like(hsml))
    pidx, gvalid = _gas_windows(tree, hsml[perm])
    zero = torch.zeros((), dtype=dtype, device=dev)
    gt = torch.where(gvalid[..., None], ps[pidx], zero).contiguous()
    gv = torch.where(gvalid[..., None], vs[pidx], zero).contiguous()
    gidx = torch.where(gvalid, pidx, torch.full_like(pidx, -1)).to(
        torch.int32).contiguous()
    walk = _Walk(cfg, seg_cap)
    rlev = range_levels(tree)
    fn = tree_density_sums_plain if plain else tree_density_sums

    def one_pass(h_flat, count_only):
        gh = torch.where(gvalid, h_flat[perm][pidx], zero).contiguous()
        glo, ghi, pad = _group_bbox(gt, gvalid & (gh > 0), gh, tree, box)
        if pidx.shape[0]:
            keys, nn = walk.segments(tree, rlev, glo, ghi, pad, box, False)
        else:
            keys = torch.empty(0, 1, dtype=torch.int32, device=dev)
            nn = torch.empty(0, dtype=torch.int32, device=dev)
        kw = dict(keys=keys, nn=nn, rows=rows, gt=gt, gv=gv, gh=gh,
                  gidx=gidx, box=box, count_only=count_only)
        if on_pass is not None:
            on_pass(kw)
        return fn(**kw)

    # the bracketed neighbour-count solve: a plain multiplicative update
    # oscillates on outliers whose count jumps across the target band
    # within one factor-2 move
    des = torch.tensor(float(params.des_num_ngb), dtype=dtype, device=dev)
    ndev = torch.tensor(float(params.max_num_ngb_dev), dtype=dtype,
                        device=dev)
    left = torch.zeros_like(hsml)
    right = torch.full_like(hsml, float("inf"))
    for _ in range(hsml_iters):
        cnt = one_pass(hsml, True).cnt
        cnt_f = _unsort(cnt, gvalid, pidx, inv, n, 0).to(dtype)
        low = cnt_f < des - ndev
        high = cnt_f > des + ndev
        left = torch.where(low, torch.maximum(left, hsml), left)
        right = torch.where(high, torch.minimum(right, hsml), right)
        prop = hsml * torch.clamp(
            (des / torch.clamp(cnt_f, min=1.0)) ** (1.0 / 3.0), 0.5, 2.0)
        bracketed = (left > 0) & torch.isfinite(right)
        prop = torch.where(bracketed, torch.sqrt(left * right), prop)
        hsml = torch.where(upd & (low | high),
                           torch.clamp(prop, min=params.min_gas_hsml), hsml)

    s = one_pass(hsml, False)
    rho = _unsort(s.rho, gvalid, pidx, inv, n, 0.0).to(dtype)
    divv = _unsort(s.divv, gvalid, pidx, inv, n, 0.0).to(dtype)
    rot = _unsort(s.rot, gvalid, pidx, inv, n, 0.0).to(dtype)
    ngb = _unsort(s.cnt, gvalid, pidx, inv, n, 0)

    rho_safe = torch.clamp(rho, min=1e-30)
    curl = torch.sqrt(torch.sum(rot * rot, dim=-1)) / rho_safe
    div_over_rho = divv / rho_safe
    # the rate terms, the DesNumNgb correction and the floors
    # (density.c:304-325), as the hash engine's
    if params.comoving:
        hubble_a = hubble_of_a(time, params.hubble, params.omega0,
                               params.omega_lambda)
        prefac = 1.0 / (hubble_a * time ** 1.5)
        dt_density = -prefac * divv
        dt_hsml = -hsml * dt_density / (3.0 * rho_safe)
    else:
        dt_density = -divv
        dt_hsml = hsml * div_over_rho / 3.0
    dt_step = 2.0 * (time - p.current_time)
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
        p, hsml=torch.where(is_gas, hsml, p.hsml),
        density=torch.where(upd, rho, p.density),
        div_vel=torch.where(upd, div_over_rho, p.div_vel),
        curl_vel=torch.where(upd, curl, p.curl_vel),
        dt_density=torch.where(upd, dt_density, p.dt_density),
        dt_hsml=torch.where(upd, dt_hsml, p.dt_hsml),
        ngb_sph=torch.where(upd, ngb, p.ngb_sph).to(torch.int32))
    info = walk.info()
    info.update(passes=hsml_iters + 1, groups=int(pidx.shape[0]),
                targets=int(torch.sum(gvalid)),
                pairs=int(torch.sum(s.cnt.long())))
    return q, info


def tree_factors(time, params: SphParams) -> PairFactors:
    """The hydro pair factors at ``time`` (a 0-d tensor of the state's
    dtype), computed in that dtype as JAX's tree engine does
    (``fused_sph.py:714-728``: its prefac is 1/(s(a) a), the hash
    engine's 1/s(a)/a, ``sph.pair_factors``)."""
    if not params.comoving:
        return PairFactors(float(params.art_bulk_visc), False, 1.0, 0.0,
                           float(time), 1.0, 1.0, 1.0)
    sqrt_a = torch.sqrt(time)
    hubble_a = hubble_of_a(time, params.hubble, params.omega0,
                           params.omega_lambda)
    prefac = 1.0 / (s_of_a(time, params.hubble, params.omega0,
                           params.omega_lambda) * time)
    vals = torch.stack([sqrt_a, hubble_a, time, prefac,
                        hubble_a * (time * time * time),
                        time * sqrt_a]).tolist()
    return PairFactors(float(params.art_bulk_visc), True, *vals)


def hydro_force_fused(p, pos_pred, vel_pred, tree, time, active,
                      params: SphParams, cfg: Optional[FusedConfig] = None,
                      box: float = 0.0, seg_cap: int = SEG_CAP,
                      plain: bool = False, on_pass=None):
    """Tree-segment ``hydro_force()`` (``hydro_force_fused`` :684-768): the
    symmetrised pressure and Monaghan viscous accelerations and du/dt of
    the gas. The pairs with r < max(h_i, h_j) come from the hmax walk
    (kernel T1: each node carries the largest h of its particles) and each
    target gathers both half-kernels of each of its pairs (kernel T3).
    Returns (acc (N, 3), zero where not gas and active; dt_egy, p.dt_egy
    where not gas and active; info as ``sph_density_fused``'s, ``pairs``
    the pairs summed). ``plain``: T3's plain version (the walk's on a CPU
    tensor); on_pass: optional observer of T3's arguments."""
    n = pos_pred.shape[0]
    dtype, dev = pos_pred.dtype, pos_pred.device
    time = torch.as_tensor(time, dtype=dtype, device=dev)
    is_gas = p.is_gas
    upd = is_gas & active
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
    f = tree_factors(time, params)

    perm, inv, ps, vs, aux = _sorted_inputs(p, pos_pred, vel_pred, tree)
    hsml = torch.where(is_gas, torch.clamp(p.hsml, min=params.min_gas_hsml),
                       torch.zeros_like(p.hsml))
    hs = hsml[perm]
    zcol = torch.zeros(n, 3, dtype=dtype, device=dev)
    rows = torch.cat([ps, aux[:, None], vs, p.mass[perm][:, None],
                      hs[:, None], rho[perm][:, None], csnd[perm][:, None],
                      f_balsara[perm][:, None], dt_step[perm][:, None],
                      zcol], dim=1).contiguous()
    pidx, gvalid = _gas_windows(tree, hs)
    zero = torch.zeros((), dtype=dtype, device=dev)
    gt = torch.where(gvalid[..., None], ps[pidx], zero).contiguous()
    gv = torch.where(gvalid[..., None], vs[pidx], zero).contiguous()
    # per slot [h m rho P/rho^2 csnd f_balsara dt 0]; dead slots JAX's
    # fills (rho 1, the rest 0)
    vals = torch.stack([hs, p.mass[perm], rho[perm], p_over_rho2[perm],
                        csnd[perm], f_balsara[perm], dt_step[perm],
                        torch.zeros_like(hs)], dim=1)[pidx]
    dead = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                        dtype=dtype, device=dev)
    gq = torch.where(gvalid[..., None], vals, dead).contiguous()
    gidx = torch.where(gvalid, pidx, torch.full_like(pidx, -1)).to(
        torch.int32).contiguous()
    walk = _Walk(cfg, seg_cap)
    gh = gq[..., 0]
    glo, ghi, pad = _group_bbox(gt, gvalid & (gh > 0), gh, tree, box)
    if pidx.shape[0]:
        keys, nn = walk.segments(tree, range_levels(tree, hs), glo, ghi,
                                 pad, box, True)
    else:
        keys = torch.empty(0, 1, dtype=torch.int32, device=dev)
        nn = torch.empty(0, dtype=torch.int32, device=dev)
    kw = dict(keys=keys, nn=nn, rows=rows, gt=gt, gv=gv, gq=gq, gidx=gidx,
              f=f, box=box)
    if on_pass is not None:
        on_pass(kw)
    out = (tree_hydro_sums_plain if plain else tree_hydro_sums)(**kw)
    acc = _unsort(out.acc, gvalid, pidx, inv, n, 0.0).to(dtype)
    dt_egy = _unsort(out.dt_egy, gvalid, pidx, inv, n, 0.0).to(dtype)
    info = walk.info()
    info.update(groups=int(pidx.shape[0]), targets=int(torch.sum(gvalid)),
                pairs=int(torch.sum(out.pairs.long())))
    return (torch.where(upd[:, None], acc, torch.zeros_like(acc)),
            torch.where(upd, dt_egy, p.dt_egy), info)
