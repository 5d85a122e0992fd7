"""Ewald periodic-boundary correction (port of ``sidm_tpu/ops/ewald.py``:
``EwaldTable`` :31-66, ``_trilerp`` :68, ``_ewald_force_grid`` /
``_ewald_psi_grid`` :79-120, ``build_ewald_table`` :122-153).

The (EN/2+1)^3 octant tables of nbody/ewald.c: force and potential
corrections from the Ewald sum (alpha = 2, +-4 real and reciprocal lattice
vectors, ewald_psi :291-327, ewald_force :332-381) for a unit box, scaled by
the box (:145-155), applied by sign-folded trilinear interpolation
(ewald_corr :171-238, ewald_pot_corr :248-284). They correct the minimum
image pair force of the periodic direct sum (``ops/direct.py``) to the
full lattice sum.

The tables are built in float64 with torch on the CPU (the JAX package
builds them in float32 unless x64 is on; near the origin its float32 force
table loses ~1e-4 of 1/r^2 to cancellation) and kept as float32. They are
cached in ``cache_dir`` as ``ewald_table_torch_<EN>.npz``, a file name of
the port's own, so a cache the JAX package wrote never decides the port's
table (nor the other way round).

Convention: ``force_correction(d)`` takes the minimum-image separation d =
x_source - x_target and returns the correction to add to the per-unit-mass
acceleration; ``pot_correction`` likewise to the per-unit-mass potential
(psi(0) = 2.8372975 / box, the lattice self energy, at d = 0).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

PSI0 = 2.8372975        # ewald.c:104-105, the unit box's psi(0)


class EwaldTable(NamedTuple):
    fcorr: torch.Tensor     # (3, ED+1, ED+1, ED+1) force correction / box^2
    potcorr: torch.Tensor   # (ED+1, ED+1, ED+1) potential correction / box
    box: float
    en: int                 # grid size EN (octant 0 .. EN/2)

    def _index(self, d):
        """Cell index i (clipped to [0, ED-1]) and fraction u of |d| on the
        octant grid (float32 arithmetic, as the JAX package)."""
        ed = self.en // 2
        scale = torch.tensor(self.en, dtype=torch.float32) / torch.tensor(
            self.box, dtype=torch.float32)
        a = torch.abs(d) * scale.to(device=d.device, dtype=d.dtype)
        i = torch.clamp(a.to(torch.int32), 0, ed - 1)
        return i.long(), a - i.to(d.dtype)

    def force_correction(self, d):
        """Trilinear lookup; d = x_source - x_target, any leading shape
        (..., 3). The tables hold the correction for separation +|d| along
        each axis; the reference's sign convention gives -sign(d) F(|d|)."""
        i, u = self._index(d)
        s = torch.sign(d)
        out = [s[..., c] * trilerp(self.fcorr[c], i, u) for c in range(3)]
        return -torch.stack(out, dim=-1)

    def pot_correction(self, d):
        """The potential correction at d (psi(0) at d = 0)."""
        i, u = self._index(d)
        return trilerp(self.potcorr, i, u)


def trilerp(t, i, u):
    """Trilinear interpolation of table t (M, M, M) at cells i (..., 3)
    int64 with fractions u (..., 3), in the JAX package's order of the
    eight corner terms."""
    ix, iy, iz = i[..., 0], i[..., 1], i[..., 2]
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    v = 0.0
    for dx_, wx in ((0, 1 - ux), (1, ux)):
        for dy_, wy in ((0, 1 - uy), (1, uy)):
            for dz_, wz in ((0, 1 - uz), (1, uz)):
                v = v + wx * wy * wz * t[ix + dx_, iy + dy_, iz + dz_]
    return v


def _lattice(nrange: int, dtype):
    rng = np.arange(-nrange, nrange + 1)
    nn = np.array(np.meshgrid(rng, rng, rng)).reshape(3, -1).T  # (M, 3)
    return torch.as_tensor(nn, dtype=dtype)


def ewald_force_grid(x, nrange: int = 4, alpha: float = 2.0):
    """ewald_force (ewald.c:332-381) over unit-box points x (..., 3)."""
    r2 = torch.sum(x * x, dim=-1)
    r2_safe = torch.clamp(r2, min=1e-30)
    force = x / (r2_safe * torch.sqrt(r2_safe))[..., None]
    nn = _lattice(nrange, x.dtype)
    dx = x[..., None, :] - nn                                   # (..., M, 3)
    r = torch.sqrt(torch.clamp(torch.sum(dx * dx, dim=-1), min=1e-30))
    val = (torch.special.erfc(alpha * r) + 2 * alpha * r / math.sqrt(math.pi)
           * torch.exp(-alpha * alpha * r * r))
    force = force - torch.sum(dx / (r ** 3)[..., None] * val[..., None],
                              dim=-2)
    h2 = torch.sum(nn * nn, dim=-1)
    sel = h2 > 0
    hdotx = torch.einsum("...d,md->...m", x, nn)
    val_k = torch.where(sel, 2.0 / torch.where(sel, h2, torch.ones_like(h2))
                        * torch.exp(-math.pi ** 2 * h2 / alpha ** 2)
                        * torch.sin(2 * math.pi * hdotx),
                        torch.zeros_like(hdotx))
    force = force - torch.einsum("...m,md->...d", val_k, nn)
    return torch.where(r2[..., None] > 0, force, torch.zeros_like(force))


def ewald_psi_grid(x, nrange: int = 4, alpha: float = 2.0):
    """ewald_psi (ewald.c:291-327) over unit-box points x (..., 3)."""
    nn = _lattice(nrange, x.dtype)
    dx = x[..., None, :] - nn
    r = torch.sqrt(torch.clamp(torch.sum(dx * dx, dim=-1), min=1e-30))
    sum1 = torch.sum(torch.special.erfc(alpha * r) / r, dim=-1)
    h2 = torch.sum(nn * nn, dim=-1)
    sel = h2 > 0
    hdotx = torch.einsum("...d,md->...m", x, nn)
    sum2 = torch.sum(torch.where(
        sel, 1.0 / (math.pi * torch.where(sel, h2, torch.ones_like(h2)))
        * torch.exp(-math.pi ** 2 * h2 / alpha ** 2)
        * torch.cos(2 * math.pi * hdotx), torch.zeros_like(hdotx)), dim=-1)
    rr = torch.sqrt(torch.clamp(torch.sum(x * x, dim=-1), min=1e-30))
    return math.pi / alpha ** 2 - sum1 - sum2 + 1.0 / rr


def unit_tables(en: int):
    """(fcorr (3, ED+1, ED+1, ED+1), potcorr) float64 numpy for the unit
    box, psi(0) set to PSI0, built row by row."""
    ed = en // 2
    grid = torch.arange(ed + 1, dtype=torch.float64) / en      # 0 .. 0.5
    gx, gy, gz = torch.meshgrid(grid, grid, grid, indexing="ij")
    x = torch.stack([gx, gy, gz], dim=-1)
    f_rows = [ewald_force_grid(x[i]) for i in range(ed + 1)]
    p_rows = [ewald_psi_grid(x[i]) for i in range(ed + 1)]
    fcorr = torch.stack(f_rows).permute(3, 0, 1, 2).numpy()
    potcorr = torch.stack(p_rows).numpy()
    potcorr[0, 0, 0] = PSI0
    return fcorr, potcorr


def build_ewald_table(box: float, en: int = 64, cache_dir: str = ".",
                      device=None) -> EwaldTable:
    """The correction tables scaled to ``box`` (float32, on ``device``),
    built for the unit box or read from ``cache_dir``'s
    ``ewald_table_torch_<EN>.npz`` (written after a build; an unwritable
    directory only skips the cache)."""
    cache = os.path.join(cache_dir, f"ewald_table_torch_{en}.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            fcorr, potcorr = z["fcorr"], z["potcorr"]
    else:
        fcorr, potcorr = unit_tables(en)
        try:
            np.savez_compressed(cache, fcorr=fcorr, potcorr=potcorr)
        except OSError:
            pass
    return EwaldTable(
        fcorr=torch.as_tensor(fcorr / box ** 2, dtype=torch.float32,
                              device=device).contiguous(),
        potcorr=torch.as_tensor(potcorr / box, dtype=torch.float32,
                                device=device).contiguous(),
        box=float(box), en=int(en))
