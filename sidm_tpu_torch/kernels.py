"""Closed-form spline softening kernels and the SPH cubic spline
(port of ``sidm_tpu/kernels.py:24-106``).

Conventions (u = r/h, h = 2.8 eps, forcetree.c:834): the softened force on a
unit-mass source is ``m * wf(u) / h^3 * dx`` for u < 1 and Newtonian
``m / r^3 * dx`` outside; the potential is ``m / h * wp(u)`` inside and
``-m / r`` outside. The CUDA kernels in ``csrc/`` evaluate the same
polynomials in the same order.
"""

from __future__ import annotations

import math

import torch


def grav_force_kernel(u):
    """wf(u) of forcetree.c:1775-1789; continuous at u=0.5 and wf(1)=1."""
    u2 = u * u
    u3 = u2 * u
    inner = 32.0 * (1.0 / 3.0 - 1.2 * u2 + u3)
    us = torch.clamp(u, min=1e-12)
    outer = (64.0 * (1.0 / 3.0 - 0.75 * u + 0.6 * u2 - u3 / 6.0)
             - 1.0 / 15.0 / (us * us * us))
    return torch.where(u < 0.5, inner, outer)


def grav_pot_kernel(u):
    """wp(u): softened potential factor; pot = m/h * wp(u), wp(1) = -1."""
    u2 = u * u
    u4 = u2 * u2
    inner = 16.0 / 3.0 * u2 - 9.6 * u4 + 6.4 * u4 * u - 2.8
    us = torch.clamp(u, min=1e-12)
    outer = (1.0 / 15.0 / us + 32.0 / 3.0 * u2 - 16.0 * u2 * u
             + 9.6 * u4 - 32.0 / 15.0 * u4 * u - 3.2)
    return torch.where(u < 0.5, inner, outer)


def softened_inv_r3(r, h, eps_floor=1e-37):
    """f(r) with force = m * f(r) * dx: 1/r^3 for r >= h, spline inside.

    Safe at r = 0 (returns the finite central value)."""
    h_inv = 1.0 / h
    u = r * h_inv
    r_safe = torch.clamp(r, min=eps_floor)
    newton = 1.0 / (r_safe * r_safe * r_safe)
    soft = grav_force_kernel(torch.clamp(u, max=1.0)) * (h_inv * h_inv * h_inv)
    return torch.where(u >= 1.0, newton, soft)


def softened_potential(r, h, eps_floor=1e-37):
    """phi(r)/m: -1/r outside h, spline inside."""
    h_inv = 1.0 / h
    u = r * h_inv
    r_safe = torch.clamp(r, min=eps_floor)
    newton = -1.0 / r_safe
    soft = grav_pot_kernel(torch.clamp(u, max=1.0)) * h_inv
    return torch.where(u >= 1.0, newton, soft)


_EIGHT_OVER_PI = 8.0 / math.pi


def sph_kernel(u):
    """Cubic-spline W(u), 8/pi normalization; W(r;h) = sph_kernel(r/h)/h^3
    (begrun.c:977-989); zero for u >= 1."""
    inner = _EIGHT_OVER_PI * (1.0 - 6.0 * u * u * (1.0 - u))
    om = 1.0 - u
    outer = (_EIGHT_OVER_PI * 2.0) * om * om * om
    w = torch.where(u < 0.5, inner, outer)
    return torch.where(u < 1.0, w, torch.zeros_like(w))


def sph_kernel_deriv(u):
    """dW/du of the cubic spline (begrun.c:980,986): W'(r;h) =
    sph_kernel_deriv(r/h)/h^4; zero for u >= 1."""
    inner = _EIGHT_OVER_PI * (-12.0 * u + 18.0 * u * u)
    om = 1.0 - u
    outer = _EIGHT_OVER_PI * (-6.0 * om * om)
    d = torch.where(u < 0.5, inner, outer)
    return torch.where(u < 1.0, d, torch.zeros_like(d))
