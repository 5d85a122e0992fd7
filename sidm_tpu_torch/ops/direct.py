"""Direct-summation gravity: the O(N^2) accuracy oracle and the force of
``ForceMethod direct`` (port of ``sidm_tpu/ops/direct.py:33``, with its
periodic branch: ``_min_image`` :28-31, the Ewald terms :82-87, the self
term :99-104).

Pairwise spline length h_ij = 2.8 max(eps_i, eps_j) (forcetree.c:1914-1917),
Newtonian beyond it. ``targets`` restricts the evaluation to a subset of
particles (the oracle of a large run checks a random sample).
``direct_gravity`` is the plain PyTorch version, chunked over targets and
sources so that N = 1e6 fits in memory; ``direct_sum`` is kernel H3
(``csrc/direct.cu``) on a CUDA tensor and the plain version on a CPU one.

A periodic ``box`` takes each pair at its minimum image (``d -
box*round(d/box)``, round half to even) and, with an ``ewald`` table
(``ops/ewald.py``), adds the Ewald correction of every pair by trilinear
lookup: the force and potential of the full lattice sum, the oracle that
TreePM is held to. The self pair's correction is psi(0) = 2.8372975/box
on the potential (the lattice self energy, kept as the reference keeps
it) and nothing on the force.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import softened_inv_r3, softened_potential
from .fused_force import min_image


def direct_gravity(pos, mass, eps, *, targets: Optional[torch.Tensor] = None,
                   target_block: int = 1024, source_chunk: int = 16384,
                   with_potential: bool = True, box: Optional[float] = None,
                   ewald=None):
    """Return raw (accel (T,3), pot (T,)) on ``targets`` (default: all
    particles). Padding (mass 0) contributes nothing. Self-interaction gives
    zero force; the self potential is removed as in potential.c:136.
    ``box``: the minimum image; ``ewald``: its EwaldTable's correction (on
    pos's device)."""
    if ewald is not None:
        source_chunk = min(source_chunk, 4096)   # the lookups' temporaries
    n = pos.shape[0]
    tidx = (torch.arange(n, device=pos.device) if targets is None
            else targets.long())
    acc = torch.zeros(tidx.shape[0], 3, dtype=pos.dtype, device=pos.device)
    pot = torch.zeros(tidx.shape[0], dtype=pos.dtype, device=pos.device)
    for t0 in range(0, tidx.shape[0], target_block):
        ti = tidx[t0:t0 + target_block]
        tp, te = pos[ti], eps[ti]
        for s0 in range(0, n, source_chunk):
            sp = pos[s0:s0 + source_chunk]
            sm = mass[s0:s0 + source_chunk]
            se = eps[s0:s0 + source_chunk]
            d = sp[None, :, :] - tp[:, None, :]
            if box:
                d = min_image(d, box)
            r = torch.sqrt(torch.sum(d * d, dim=-1))
            h = 2.8 * torch.maximum(te[:, None], se[None, :])
            f = softened_inv_r3(r, h) * sm[None, :]
            acc[t0:t0 + ti.shape[0]] += torch.einsum("bs,bsd->bd", f, d)
            if with_potential:
                pot[t0:t0 + ti.shape[0]] += torch.sum(
                    softened_potential(r, h) * sm[None, :], dim=-1)
            if ewald is not None:
                acc[t0:t0 + ti.shape[0]] += torch.sum(
                    sm[None, :, None] * ewald.force_correction(d), dim=1)
                if with_potential:
                    pot[t0:t0 + ti.shape[0]] += torch.sum(
                        sm[None, :] * ewald.pot_correction(d), dim=-1)
    if with_potential:
        pot = pot + mass[tidx] / eps[tidx]
    return acc, pot


def direct_sum(pos, mass, eps, *, targets: Optional[torch.Tensor] = None,
               with_potential: bool = True, box: Optional[float] = None,
               ewald=None):
    """``direct_gravity``'s function: raw (accel (T, 3), pot (T,)) on
    ``targets`` (default all; pot zeros without ``with_potential``). On a
    CUDA tensor one launch of ``csrc/direct.cu`` (a target a thread,
    sources tiled through shared memory, float64 sums of float32 tiles),
    held to the plain version at p99.9 relative error < 1e-5. A periodic
    ``box`` needs its ``ewald`` table: the kernel's periodic mode takes the
    minimum image (``rintf``, half to even) and the trilinear Ewald
    lookups from the tables in global memory (0.57 MB at EN = 64, read
    through the read-only cache; they stay in L2)."""
    if box and ewald is None:
        raise ValueError("direct_sum: a periodic box needs its Ewald table")
    if not pos.is_cuda:
        acc, pot = direct_gravity(pos, mass, eps, targets=targets,
                                  with_potential=with_potential, box=box,
                                  ewald=ewald)
        return acc, pot
    from .._build import check_cuda, kernels_lib, launch_args
    n = pos.shape[0]
    check_cuda("direct_sum", pos=(pos, torch.float32, (n, 3)),
               mass=(mass, torch.float32, (n,)),
               eps=(eps, torch.float32, (n,)))
    tg = None
    T = n
    if targets is not None:
        tg = targets.to(torch.int32).contiguous()
        T = tg.shape[0]
        check_cuda("direct_sum", targets=(tg, torch.int32, (T,)))
    acc = torch.empty(T, 3, dtype=torch.float32, device=pos.device)
    pot = (torch.empty(T, dtype=torch.float32, device=pos.device)
           if with_potential else None)
    periodic = bool(box)
    if periodic:
        ed1 = ewald.en // 2 + 1
        check_cuda("direct_sum", pos=(pos, torch.float32, (n, 3)),
                   fcorr=(ewald.fcorr, torch.float32, (3, ed1, ed1, ed1)),
                   potcorr=(ewald.potcorr, torch.float32, (ed1, ed1, ed1)))
    err = kernels_lib().direct_launch(*launch_args(
        pos, mass, eps, n, tg, T, acc, pot,
        ewald.fcorr if periodic else None,
        ewald.potcorr if periodic else None, float(box or 0.0),
        int(ewald.en if periodic else 0), int(periodic)))
    if err:
        raise RuntimeError(f"direct kernel launch failed: CUDA error {err}")
    if periodic:
        direct_sum.periodic_launches += 1
    else:
        direct_sum.launches += 1
    if not with_potential:
        return acc, torch.zeros(T, dtype=pos.dtype, device=pos.device)
    ti = torch.arange(n, device=pos.device) if tg is None else tg.long()
    return acc, pot + mass[ti] / eps[ti]


direct_sum.launches = 0
direct_sum.periodic_launches = 0   # launches of the periodic mode (box)
