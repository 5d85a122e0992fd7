"""Particle-mesh long-range gravity, the TreePM split, for periodic boxes
and for isolated runs (port of ``sidm_tpu/ops/pm.py``: ``PMKernel`` :56,
``short_range_screen``/``_fac``/``_pot`` :89-128, ``build_pm_kernel``
:131-171, ``cic_deposit``/``cic_gather`` :194-270, ``pm_accel`` :273-354;
the free-space mesh ``PMKernelFree`` :370, ``build_pm_kernel_free``
:391-439 and ``pm_accel_free`` :442-490).

The periodic force is split Ewald-style: a_total = a_short + a_long.
``a_short`` is the spline-softened pair force times the real-space screen
S(r) = erfc(a r) + (2 a r / sqrt(pi)) exp(-a^2 r^2), at the minimum image
and cut at ``rcut`` (the tree walk's periodic mode, ``wq_force``);
``a_long`` is the Gaussian-filtered Poisson solve on a CIC mesh, here.

What differs from the JAX package. Its 3D transforms are complex matmul
DFTs (an MXU shape on the TPU); here they are ``torch.fft.rfftn`` /
``irfftn`` on the half spectrum. JAX takes the real part of a full complex
inverse transform; ``irfftn`` needs a Hermitian half spectrum, so every
field's spectrum X is replaced by its Hermitian part (X(k) + conj X(-k))/2,
which has the same real inverse: the same function, also on the Nyquist
planes, where the interlacing phase is not Hermitian. The deposit is one
``index_add_`` per corner (JAX sorts by cell and takes blocked range sums,
the TPU having no fast scatter-add): the same sums in another order, within
1e-6 of the grid's largest cell (tests/test_torch_pm.py). The grids are
float32, as JAX's.

The free-space mesh (``PMVacuum``, an isolated run's far field) is the
Hockney-Eastwood zero-padded convolution: the density of an n-cell region
of side L is deposited as in a box of L (positions clamped 1.6 cells
inside the region, which only moves escapers: the region's margin keeps
every particle 2 cells in), zero-padded to a 2n grid, and convolved with
the DFT of the real-space screened kernel -erf(alpha r)/r sampled on the
2n grid (minimum image on the doubled box): the cyclic convolution is then
the exact linear one for every pair of the region. The fields are the
periodic solve's, on the 2n grid, cut back to the region's n^3 cells.
JAX transforms the kernel with its float32 matmul DFT; here ``torch.fft``
in float64 at build time, rounded once to float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import softened_inv_r3, softened_potential

SQRT_PI = math.sqrt(math.pi)
PROBE = (0.3811, 0.5377, 0.2629)   # build_pm_kernel's self-potential probe


class PMKernel(NamedTuple):
    """The mesh operator of one (box, n, asmth) combination."""
    greens: torch.Tensor  # (n, n, n//2+1) -4pi exp(-k^2/4a^2)/(k^2 W^2 V)
    kvec: torch.Tensor    # (n,) physical k per axis index (signed)
    box: float
    n: int
    alpha: float          # the split scale 1/(2 asmth h)
    rcut: float           # the short range's cut
    pot_self: float       # mesh potential of a unit mass at its position
    interlace: bool       # half-cell interlaced deposit and gather


def short_range_screen(r, alpha):
    """S(r) = erfc(a r) + (2/sqrt(pi)) a r exp(-(a r)^2), the screen of the
    Newtonian pair force (ewald.c:332-381's real-lattice term, n = 0)."""
    x = alpha * r
    return torch.special.erfc(x) + (2.0 / SQRT_PI) * x * torch.exp(-x * x)


def short_range_fac(r, h, alpha):
    """Screened softened force factor (acc += m fac d): softened_inv_r3 -
    g(r), g = (1 - S(r))/r^3 = a^3 (erf(x) - 2x/sqrt(pi) e^-x^2)/x^3, by
    its series below x = a r = 0.2 (finite at r = 0). On the Newtonian
    range (r >= h) it is S(r)/r^3, evaluated so: JAX's difference 1/r^3 -
    g of two nearly equal terms loses 1/S(r) times the float32 rounding,
    ~2400x at a r = 3 (rcut at the default split)."""
    x = alpha * r
    x2 = x * x
    small = x < 0.2
    xs = torch.clamp(x, min=1e-12)
    g_dir = (torch.special.erf(xs) - (2.0 / SQRT_PI) * xs
             * torch.exp(-x2)) / (xs * xs * xs)
    g_ser = (4.0 / (3.0 * SQRT_PI)) * (1.0 - 0.6 * x2
                                       + (3.0 / 14.0) * x2 * x2)
    g = alpha ** 3 * torch.where(small, g_ser, g_dir)
    r_safe = torch.clamp(r, min=1e-30)
    newton = short_range_screen(r, alpha) / (r_safe * r_safe * r_safe)
    return torch.where(r >= h, newton, softened_inv_r3(r, h) - g)


def short_range_pot(r, h, alpha):
    """Screened softened pair potential (pot += m this):
    softened_potential + erf(a r)/r, by its series below a r = 0.1
    (2a/sqrt(pi) at r = 0); on the Newtonian range -erfc(a r)/r, evaluated
    so (JAX's -1/r + erf(a r)/r cancels to erfc(3) = 2.2e-5 of each term
    at rcut)."""
    x = alpha * r
    xs = torch.clamp(x, min=1e-12)
    e_dir = torch.special.erf(xs) / torch.clamp(r, min=1e-30)
    e_ser = alpha * (2.0 / SQRT_PI) * (1.0 - x * x / 3.0)
    e = torch.where(x < 0.1, e_ser, e_dir)
    newton = -torch.special.erfc(x) / torch.clamp(r, min=1e-30)
    return torch.where(r >= h, newton, softened_potential(r, h) + e)


def build_pm_kernel(box: float, n: int = 128, asmth: float = 1.25,
                    rcut_fac: float = 4.5, interlace: bool = True,
                    device=None) -> PMKernel:
    """The Green's function, the split constants and the mesh's
    self-potential (a unit mass at an off-grid probe) for one box."""
    h = box / n
    alpha = 1.0 / (2.0 * asmth * h)
    rcut = rcut_fac * asmth * h
    p = np.arange(n)
    m = np.where(p > n // 2, p - n, p).astype(np.float64)   # signed modes
    k1 = 2.0 * np.pi / box * m
    s = np.sinc(m / n)
    w1 = s * s                                              # CIC window
    kx, ky, kz = k1[:, None, None], k1[None, :, None], k1[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    w2 = (w1[:, None, None] * w1[None, :, None] * w1[None, None, :]) ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        g = -4.0 * np.pi * np.exp(-k2 / (4.0 * alpha * alpha)) \
            / (k2 * w2 * box ** 3)
    g[0, 0, 0] = 0.0            # uniform background
    kern = PMKernel(
        greens=torch.as_tensor(g[:, :, :n // 2 + 1].astype(np.float32),
                               device=device).contiguous(),
        kvec=torch.as_tensor(k1.astype(np.float32), device=device),
        box=float(box), n=int(n), alpha=float(alpha), rcut=float(rcut),
        pot_self=0.0, interlace=bool(interlace))
    probe = torch.tensor([[c * box for c in PROBE]], dtype=torch.float32,
                         device=device)
    _, pot = pm_accel(kern, probe, torch.ones(1, dtype=torch.float32,
                                              device=device),
                      with_potential=True)
    return kern._replace(pot_self=float(pot[0]))


def _cic_corners(pos, box: float, n: int):
    """CIC base cell (wrapped) and the +1 corner's weight per axis."""
    f = pos / (box / n) - 0.5
    i0 = torch.floor(f)
    w = f - i0
    return torch.remainder(i0.long(), n), w


def _flat(i, n: int):
    return (i[..., 0] * n + i[..., 1]) * n + i[..., 2]


def _corner(k: int):
    return (k >> 2) & 1, (k >> 1) & 1, k & 1


def cic_deposit(pos, mass, box: float, n: int):
    """Mass per cell (n, n, n) float32: each particle's eight CIC corner
    weights (corner dx*4+dy*2+dz, weight (wx wy) wz m) added to their
    cells, one ``index_add_`` per corner."""
    i0, w = _cic_corners(pos, box, n)
    wx = torch.stack([1.0 - w[:, 0], w[:, 0]], dim=1)
    wy = torch.stack([1.0 - w[:, 1], w[:, 1]], dim=1)
    wz = torch.stack([1.0 - w[:, 2], w[:, 2]], dim=1)
    rho = torch.zeros(n ** 3, dtype=torch.float32, device=pos.device)
    for k in range(8):
        o = _corner(k)
        val = wx[:, o[0]] * wy[:, o[1]] * wz[:, o[2]] * mass
        idx = _flat(torch.remainder(i0 + torch.tensor(o, device=pos.device),
                                    n), n)
        rho.index_add_(0, idx, val.to(torch.float32))
    return rho.reshape(n, n, n)


def cic_gather(field4, pos, box: float, n: int):
    """The packed (n^3, 4) [ax, ay, az, pot] rows interpolated at the
    positions (the eight corners in order)."""
    i0, w = _cic_corners(pos, box, n)
    out = torch.zeros(pos.shape[:-1] + (4,), dtype=torch.float32,
                      device=pos.device)
    for k in range(8):
        o = _corner(k)
        ic = torch.remainder(i0 + torch.tensor(o, device=pos.device), n)
        wk = ((w[..., 0] if o[0] else 1.0 - w[..., 0])
              * (w[..., 1] if o[1] else 1.0 - w[..., 1])
              * (w[..., 2] if o[2] else 1.0 - w[..., 2]))
        out = out + wk[..., None] * field4[_flat(ic, n)]
    return out


def _k_grids(kv, m: int):
    """Per axis the k of the half spectrum's indices and of their negated
    indices (k~: -k, but +k on the Nyquist plane, whose index is its own
    negative), as broadcastable (m, m, m//2+1) factors of an m grid."""
    kneg = kv[torch.remainder(-torch.arange(m, device=kv.device), m)]
    hz = m // 2 + 1
    k = (kv[:, None, None], kv[None, :, None], kv[None, None, :hz])
    kt = (kneg[:, None, None], kneg[None, :, None], kneg[None, None, :hz])
    return k, kt


def _solver(greens, kvec, m: int, r1, r2, h: float, with_potential: bool,
            crop: int):
    """The mesh's real-space fields from the density spectra: r1 (and r2,
    the half-cell shifted deposit's, None when not interlaced) the
    half spectra of an m grid, greens its Green's function. Returns
    ``solve(shift)``: the packed (crop^3, 4) [ax, ay, az, pot] rows of the
    first crop^3 cells (pot 0 unless with_potential), at the grid points
    or (shift) at the half-cell shifted ones."""
    fft = torch.fft
    (kx, ky, kz), (kxt, kyt, kzt) = _k_grids(kvec, m)
    if r2 is not None:
        ph = 0.5 * h * (kx + ky + kz)
        pht = 0.5 * h * (kxt + kyt + kzt)
        e = torch.polar(torch.ones_like(ph), ph)            # e^{i ph(k)}
        et_c = torch.polar(torch.ones_like(pht), -pht)      # e^{-i ph(k~)}
        # the combined density at k, and its conjugate at k~ (each grid's
        # own spectrum is Hermitian: rho_j(k~) = conj rho_j(k))
        phi = greens * 0.5 * (r1 + r2 * e)
        phit = greens * 0.5 * (r1 + r2 * et_c)
    else:
        phi = phit = greens * r1

    def field(f, ft_c):
        """Real-space field of the spectrum f(k) phi(k): the inverse of its
        Hermitian part (f phi + conj(f(k~) phi(k~)))/2, ft_c = conj f(k~)."""
        g = fft.irfftn(0.5 * (f * phi + ft_c * phit), s=(m, m, m),
                       norm="forward")
        return g[:crop, :crop, :crop].reshape(-1)

    def solve(shift: bool):
        grads = [(-1j * kc, 1j * kct) for kc, kct in ((kx, kxt), (ky, kyt),
                                                      (kz, kzt))]
        pots = [(1.0, 1.0)] if with_potential else []
        out = []
        for f, ft_c in grads + pots:
            if shift:
                f, ft_c = f * e, ft_c * et_c
            out.append(field(f, ft_c))
        if not with_potential:
            out.append(torch.zeros(crop ** 3, dtype=torch.float32,
                                   device=r1.device))
        return torch.stack(out, dim=-1)                     # (crop^3, 4)

    return solve


def pm_accel(kern: PMKernel, pos, mass, *, with_potential: bool = False):
    """Long-range acceleration and (with_potential) potential, raw units
    (no G): (acc (N, 3), pot (N,)) in the positions' dtype. pot keeps the
    mesh self term; the caller subtracts mass * pot_self and adds psi(0).

    With ``interlace`` the density is deposited on the grid and on a
    half-cell shifted copy, combined in k space with the alias-cancelling
    phase, and the fields are gathered from both grids."""
    n, box = kern.n, kern.box
    h = box / n
    dtype = pos.dtype
    pos = torch.remainder(pos, box)
    r1 = torch.fft.rfftn(cic_deposit(pos, mass, box, n))
    r2 = (torch.fft.rfftn(cic_deposit(torch.remainder(pos + 0.5 * h, box),
                                      mass, box, n))
          if kern.interlace else None)
    solve = _solver(kern.greens, kern.kvec, n, r1, r2, h, with_potential, n)
    out = cic_gather(solve(False), pos, box, n)
    if kern.interlace:
        out2 = cic_gather(solve(True), torch.remainder(pos - 0.5 * h, box),
                          box, n)
        out = 0.5 * (out + out2)
    return out[..., :3].to(dtype), out[..., 3].to(dtype)


class PMKernelFree(NamedTuple):
    """The free-space mesh operator of one region (``PMVacuum``)."""
    greens: torch.Tensor  # (2n, 2n, n+1) DFT[-erf(ar)/r] / (2n)^3 / W^2
    kvec: torch.Tensor    # (2n,) physical k of the padded grid (signed)
    origin: torch.Tensor  # (3,) float32 position of grid point (0, 0, 0)
    box: float            # the region's side L (n cells)
    n: int                # the region's mesh (the padded grid is 2n)
    alpha: float
    rcut: float
    pot_self: float       # mesh potential of a unit mass at its position
    interlace: bool


PROBE_FREE = (0.0811, 0.0377, -0.0629)  # build_pm_kernel_free's probe, in
                                        # units of the radius from the centre


def build_pm_kernel_free(center, radius: float, n: int = 128,
                         asmth: float = 1.25, rcut_fac: float = 4.5,
                         interlace: bool = True,
                         device=None) -> PMKernelFree:
    """The free-space mesh of the sphere (center, radius): the region's
    side L solves L = 2 radius + 2 (rcut + 2h) with h = L/n (so every
    particle and its interlaced half-cell images deposit without a wrap,
    and no short-range ball reaches the padding), the split constants, the
    Green's function of the 2n grid and the mesh's self-potential (a unit
    mass at an off-grid probe)."""
    pad_cells = 2.0 * (rcut_fac * asmth + 2.0)
    L = 2.0 * float(radius) / max(1.0 - pad_cells / n, 0.5)
    h = L / n
    alpha = 1.0 / (2.0 * asmth * h)
    rcut = rcut_fac * asmth * h
    m = 2 * n
    p = np.arange(m)
    # the real-space screened kernel on the doubled box (minimum image),
    # transformed in float64 on the device (a real even kernel: a real
    # spectrum)
    imi = ((p + n) % m) - n                       # [-n, n)
    r1 = torch.as_tensor(np.abs(imi) * h, dtype=torch.float64, device=device)
    r = torch.sqrt(r1[:, None, None] ** 2 + r1[None, :, None] ** 2
                   + r1[None, None, :] ** 2)
    g = -torch.special.erf(alpha * r) / torch.where(r > 0, r,
                                                     torch.ones_like(r))
    g[0, 0, 0] = -2.0 * alpha / SQRT_PI
    del r
    gr = torch.fft.rfftn(g).real
    del g
    mm = np.where(p > m // 2, p - m, p).astype(np.float64)
    s = np.sinc(mm / m)
    w1 = s * s
    w2 = torch.as_tensor((w1[:, None, None] * w1[None, :, None]
                          * w1[None, None, :m // 2 + 1]) ** 2 * m ** 3,
                         device=device)
    greens = (gr / w2).to(torch.float32).contiguous()
    del gr, w2
    k1 = 2.0 * np.pi / (m * h) * mm
    center = np.asarray(center, np.float64)
    kern = PMKernelFree(
        greens=greens,
        kvec=torch.as_tensor(k1.astype(np.float32), device=device),
        origin=torch.as_tensor((center - 0.5 * L).astype(np.float32),
                               device=device),
        box=float(L), n=int(n), alpha=float(alpha), rcut=float(rcut),
        pot_self=0.0, interlace=bool(interlace))
    probe = torch.tensor(
        (center + np.array(PROBE_FREE) * radius)[None].astype(np.float32),
        device=device)
    _, pot = pm_accel_free(kern, probe, torch.ones(1, dtype=torch.float32,
                                                   device=device),
                           with_potential=True)
    return kern._replace(pot_self=float(pot[0]))


def _region_coords(kern: PMKernelFree, pos):
    """Positions relative to the free-space region's corner, and the same
    clamped 1.6 cells inside it (the region's margin keeps real particles
    2 cells in: only escapers move)."""
    h = kern.box / kern.n
    q0 = pos.to(torch.float32) - kern.origin[None, :]
    return q0, torch.clamp(q0, 1.6 * h, kern.box - 1.6 * h)


def count_clamped(kern: PMKernelFree, pos, mass):
    """The particles of mass > 0 that ``pm_accel_free``'s clamp moves into
    the region, whose mesh force is then taken at the clamp point (a 0-d
    int64 tensor; JAX's clamp counts nothing: ROADMAP C.22)."""
    q0, q = _region_coords(kern, pos)
    return torch.sum(torch.any(q != q0, dim=1) & (mass > 0))


def pm_accel_free(kern: PMKernelFree, pos, mass, *,
                  with_potential: bool = False):
    """Long-range acceleration (and potential) of an isolated particle set
    on the free-space mesh, with ``pm_accel``'s conventions (raw units, the
    mesh self term left in pot). Positions are clamped 1.6 cells inside
    the region first (``count_clamped`` counts the particles it moves)."""
    n, L = kern.n, kern.box
    m = 2 * n
    h = L / n
    dtype = pos.dtype
    q = _region_coords(kern, pos)[1]
    s = (m, m, m)
    r1 = torch.fft.rfftn(cic_deposit(q, mass, L, n), s=s)
    r2 = (torch.fft.rfftn(cic_deposit(q + 0.5 * h, mass, L, n), s=s)
          if kern.interlace else None)
    solve = _solver(kern.greens, kern.kvec, m, r1, r2, h, with_potential, n)
    out = cic_gather(solve(False), q, L, n)
    if kern.interlace:
        out2 = cic_gather(solve(True), q - 0.5 * h, L, n)
        out = 0.5 * (out + out2)
    return out[..., :3].to(dtype), out[..., 3].to(dtype)
