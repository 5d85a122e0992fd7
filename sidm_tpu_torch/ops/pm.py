"""Particle-mesh long-range gravity for periodic boxes, the TreePM split
(port of ``sidm_tpu/ops/pm.py``, the periodic part: ``PMKernel`` :56,
``short_range_screen``/``_fac``/``_pot`` :89-128, ``build_pm_kernel``
:131-171, ``cic_deposit``/``cic_gather`` :194-270, ``pm_accel`` :273-354).

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
float32, as JAX's. ``pm_accel_free`` (``PMVacuum``) is not ported (ROADMAP
A).
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


def _k_grids(kern: PMKernel):
    """Per axis the k of the half spectrum's indices and of their negated
    indices (k~: -k, but +k on the Nyquist plane, whose index is its own
    negative), as broadcastable (n, n, n//2+1) factors."""
    n = kern.n
    kv = kern.kvec
    kneg = kv[torch.remainder(-torch.arange(n, device=kv.device), n)]
    hz = n // 2 + 1
    k = (kv[:, None, None], kv[None, :, None], kv[None, None, :hz])
    kt = (kneg[:, None, None], kneg[None, :, None], kneg[None, None, :hz])
    return k, kt


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
    fft = torch.fft
    r1 = fft.rfftn(cic_deposit(pos, mass, box, n))
    (kx, ky, kz), (kxt, kyt, kzt) = _k_grids(kern)
    if kern.interlace:
        ph = 0.5 * h * (kx + ky + kz)
        pht = 0.5 * h * (kxt + kyt + kzt)
        e = torch.polar(torch.ones_like(ph), ph)            # e^{i ph(k)}
        et_c = torch.polar(torch.ones_like(pht), -pht)      # e^{-i ph(k~)}
        r2 = fft.rfftn(cic_deposit(torch.remainder(pos + 0.5 * h, box), mass,
                                   box, n))
        # the combined density at k, and its conjugate at k~ (each grid's
        # own spectrum is Hermitian: rho_j(k~) = conj rho_j(k))
        phi = kern.greens * 0.5 * (r1 + r2 * e)
        phit = kern.greens * 0.5 * (r1 + r2 * et_c)
    else:
        phi = phit = kern.greens * r1

    def field(f, ft_c):
        """Real-space field of the spectrum f(k) phi(k): the inverse of its
        Hermitian part (f phi + conj(f(k~) phi(k~)))/2, ft_c = conj f(k~)."""
        return fft.irfftn(0.5 * (f * phi + ft_c * phit), s=(n, n, n),
                          norm="forward").reshape(-1)

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
            out.append(torch.zeros(n ** 3, dtype=torch.float32,
                                   device=pos.device))
        return torch.stack(out, dim=-1)                     # (n^3, 4)

    out = cic_gather(solve(False), pos, box, n)
    if kern.interlace:
        out2 = cic_gather(solve(True), torch.remainder(pos - 0.5 * h, box),
                          box, n)
        out = 0.5 * (out + out2)
    return out[..., :3].to(dtype), out[..., 3].to(dtype)
