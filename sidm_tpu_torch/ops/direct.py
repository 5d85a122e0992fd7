"""Direct-summation gravity: the O(N^2) accuracy oracle and the force of
``ForceMethod direct`` (port of ``sidm_tpu/ops/direct.py:33``,
non-periodic).

Pairwise spline length h_ij = 2.8 max(eps_i, eps_j) (forcetree.c:1914-1917),
Newtonian beyond it. ``targets`` restricts the evaluation to a subset of
particles (the oracle of a large run checks a random sample).
``direct_gravity`` is the plain PyTorch version, chunked over targets and
sources so that N = 1e6 fits in memory; ``direct_sum`` is kernel H3
(``csrc/direct.cu``) on a CUDA tensor and the plain version on a CPU one.
A periodic box (the minimum image and the Ewald correction) is not ported
(ROADMAP.md A, item 11).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import softened_inv_r3, softened_potential


def direct_gravity(pos, mass, eps, *, targets: Optional[torch.Tensor] = None,
                   target_block: int = 1024, source_chunk: int = 16384,
                   with_potential: bool = True):
    """Return raw (accel (T,3), pot (T,)) on ``targets`` (default: all
    particles). Padding (mass 0) contributes nothing. Self-interaction gives
    zero force; the self potential is removed as in potential.c:136."""
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
            r = torch.sqrt(torch.sum(d * d, dim=-1))
            h = 2.8 * torch.maximum(te[:, None], se[None, :])
            f = softened_inv_r3(r, h) * sm[None, :]
            acc[t0:t0 + ti.shape[0]] += torch.einsum("bs,bsd->bd", f, d)
            if with_potential:
                pot[t0:t0 + ti.shape[0]] += torch.sum(
                    softened_potential(r, h) * sm[None, :], dim=-1)
    if with_potential:
        pot = pot + mass[tidx] / eps[tidx]
    return acc, pot


def direct_sum(pos, mass, eps, *, targets: Optional[torch.Tensor] = None,
               with_potential: bool = True, box=None):
    """``direct_gravity``'s function: raw (accel (T, 3), pot (T,)) on
    ``targets`` (default all; pot zeros without ``with_potential``). On a
    CUDA tensor one launch of ``csrc/direct.cu`` (a target a thread,
    sources tiled through shared memory, float64 sums of float32 tiles),
    held to the plain version at p99.9 relative error < 1e-5. A periodic
    ``box`` (the minimum image and the Ewald correction) raises."""
    if box:
        raise NotImplementedError(
            "the periodic direct sum (minimum image and Ewald correction) is "
            "not ported to sidm_tpu_torch yet (ROADMAP.md A, item 11)")
    if not pos.is_cuda:
        acc, pot = direct_gravity(pos, mass, eps, targets=targets,
                                  with_potential=with_potential)
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
    err = kernels_lib().direct_launch(*launch_args(
        pos, mass, eps, n, tg, T, acc, pot))
    if err:
        raise RuntimeError(f"direct kernel launch failed: CUDA error {err}")
    direct_sum.launches += 1
    if not with_potential:
        return acc, torch.zeros(T, dtype=pos.dtype, device=pos.device)
    ti = torch.arange(n, device=pos.device) if tg is None else tg.long()
    return acc, pot + mass[ti] / eps[ti]


direct_sum.launches = 0
