"""DSMC pair scattering pieces shared by the scattering engines (port of
``sidm_tpu/ops/sidm.py``: ``SidmParams`` :58, ``_collect_events`` :311,
``_perp_unit`` :340, ``_resolve_conflicts_compact`` :392).

The conflict resolution is the JAX package's deterministic greedy matching
by target index: a proposal (i -> j) executes when i is the lowest-index
pending proposal touching either i or j, and proposals whose endpoints get
taken are cancelled. JAX runs the rounds in a ``while_loop``; here they run
as a host loop until nothing is pending, one device-to-host read per round
(the proposers are a few thousand per step, the rounds a handful).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SidmParams(NamedTuple):
    """The JAX ``SidmParams`` fields that the tree engines read (the hash
    engine's ``cap``/``block``/``n_levels``, ROADMAP A.9, are not
    ported). ``log_events``: the scatter log's per-event records, the first
    ``event_cap`` of a step (``collect_events``)."""
    cross_section_internal: float
    cross_section_type: int
    yukawa_velocity: float
    cross_section_vel_scale: float
    cross_section_pow_law: float
    des_num_ngb: int
    max_num_ngb_dev: int
    comoving: bool
    hubble: float
    omega0: float
    omega_lambda: float
    log_events: bool = False     # SCATTERLOG (Makefile -DSCATTERLOG)
    event_cap: int = 4096        # max logged events per step
    maintenance_rate: float = 0.03  # hsml-controller sampling for ungated


def collect_events(p, pos_pred, time, accepted, pj, dv_i, cap: int):
    """The step's SCATTERLOG records (struct scatlog, nbody/sidm.h:1-10),
    the first ``cap`` accepted targets in particle order, on the device and
    without a host read: (rec (cap, 18) [time, h1, h2, x1(3), x2(3),
    v1(3), v2(3), dv(3)] in the state's dtype, ids (cap, 2) int32 [id1,
    id2], count = min(accepted, cap) as a 0-d tensor). Rows past the count
    are 0; the accepted targets past ``cap`` are not recorded (JAX drops
    them silently; ``Simulation`` counts them). ``p`` is the state after
    the pass (its controller's ``hsml_vd``), as JAX takes it."""
    n = accepted.shape[0]
    cap = min(int(cap), n)
    n_acc = torch.sum(accepted)
    slot = torch.cumsum(accepted.long(), 0) - 1
    slot = torch.where(accepted & (slot < cap), slot,
                       torch.full_like(slot, cap))
    i = torch.full((cap + 1,), n, dtype=torch.long, device=accepted.device)
    i = i.scatter_(0, slot, torch.arange(n, device=accepted.device))[:cap]
    valid = i < n
    i = torch.clamp(i, max=n - 1)
    j = pj[i].long()
    rec = torch.cat([
        torch.as_tensor(time, dtype=pos_pred.dtype,
                        device=pos_pred.device).reshape(1, 1).expand(cap, 1),
        p.hsml_vd[i][:, None], p.hsml_vd[j][:, None], pos_pred[i],
        pos_pred[j], p.vel[i], p.vel[j], dv_i[i]], dim=1)
    rec = torch.where(valid[:, None], rec, torch.zeros_like(rec))
    ids = torch.stack([p.pid[i], p.pid[j]], dim=1).to(torch.int32)
    ids = torch.where(valid[:, None], ids, torch.zeros_like(ids))
    return rec, ids, torch.clamp(n_acc, max=cap)


def perp_unit(a, b):
    """Unit vector perpendicular to a (and b), cf. perp() sidm.c:29-53;
    for a parallel to b (or zero) any perpendicular of a."""
    c = torch.linalg.cross(a, b)
    norm = torch.sqrt(torch.sum(c * c, dim=-1, keepdim=True))
    ex = torch.zeros_like(a)
    ex[..., 0] = 1.0
    alt = torch.linalg.cross(a, ex)
    alt_n = torch.sqrt(torch.sum(alt * alt, dim=-1, keepdim=True))
    use_alt = norm < 1e-20
    c = torch.where(use_alt, alt, c)
    norm = torch.where(use_alt, alt_n, norm)
    return c / torch.clamp(norm, min=1e-30)


def resolve_conflicts_compact(proposal, n: int, cap: int = 65536):
    """Accepted set of the proposals (``proposal[i]`` = partner of i, -1
    for none): the JAX package's greedy rounds over the first ``cap``
    proposers in index order. Returns (accepted (n,) bool, rounds, the
    proposers past ``cap``, which JAX drops silently: ROADMAP C.3, the
    proposers taken (P,) and which of them were accepted (P,))."""
    dev = proposal.device
    ti = torch.nonzero(proposal >= 0).flatten()
    dropped = max(int(ti.numel()) - cap, 0)
    ti = ti[:cap]
    tj = torch.clamp(proposal[ti].long(), 0, n - 1)
    pending = torch.ones(ti.numel(), dtype=torch.bool, device=dev)
    acc = torch.zeros_like(pending)
    rounds = 0
    while ti.numel() and bool(pending.any()):
        rounds += 1
        prop_i = torch.where(pending, ti, torch.full_like(ti, n))
        touch = torch.full((n,), n, dtype=ti.dtype, device=dev)
        touch.scatter_reduce_(0, ti, prop_i, "amin")
        touch.scatter_reduce_(0, tj, prop_i, "amin")
        safe = pending & (touch[ti] == ti) & (touch[tj] == ti)
        acc |= safe
        taken = torch.zeros(n, dtype=torch.bool, device=dev)
        taken[ti[safe]] = True
        taken[tj[safe]] = True
        pending = pending & ~safe & ~taken[ti] & ~taken[tj]
    accepted = torch.zeros(n, dtype=torch.bool, device=dev)
    accepted[ti] = acc
    return accepted, rounds, dropped, ti, acc
