"""Work items of about equal size for the near and list-far kernels: the
plain version of the split that ``csrc/work_items.cuh`` (``items_plan``)
and ``csrc/near_kernel.cu`` (``near_count``, ``near_mark``) make on the
card, and the layout of their integer workspace.

A group of weight w (covered particles for the near kernel, list entries
for the far kernel) is cut into ceil(w / P) items of ceil(w / items) each,
with one P per call: P = max(p_min, ceil(sum w / (icap - ng))), so that
there are at most ``icap = item_cap(ng)`` items whatever the lists hold.
Items are numbered group by group, in order; each kernel writes one
(64, 4) partial per item and a second pass adds a group's partials in item
order.
"""

from __future__ import annotations

import torch

IMAX = 2147483647
NEAR_P_MIN = 512   # csrc/near_kernel.cu kPMin: least particles per item
FAR_E_MIN = 256    # csrc/far_list.cu kEMin: least list entries per item


def item_cap(ng: int) -> int:
    """Most items one call can have (the partial buffer's rows)."""
    return 2 * ng + 1024


def ws_size(ng: int, icap: int, near: bool) -> int:
    """int32 workspace of ``csrc/work_items.cuh`` ``ws_of``: unit[ng]
    off[ng+1] item_g[icap], and for the near kernel cov[ng] k0[icap]
    k1[icap] after them."""
    return 2 * ng + 1 + icap + (ng + 2 * icap if near else 0)


def item_buffers(ng: int, device, near: bool):
    """(icap, int32 workspace, (icap, 64, 4) float32 partials) for one
    kernel call over ng groups; the kernels write all they read."""
    icap = item_cap(ng)
    return (icap,
            torch.empty(ws_size(ng, icap, near), dtype=torch.int32,
                        device=device),
            torch.empty(icap, 64, 4, dtype=torch.float32, device=device))


def kernel_split(entry: str, near: bool, ng: int, *args) -> dict:
    """Run a kernel's split launches alone (C entry point ``entry``, its
    arguments ``args`` before the workspace) and return the workspace's
    fields."""
    from .._build import kernels_lib, launch_args

    icap = item_cap(ng)
    ws = torch.empty(ws_size(ng, icap, near), dtype=torch.int32,
                     device=args[0].device)
    err = getattr(kernels_lib(), entry)(*launch_args(*args, ws, icap))
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return ws_fields(ws, ng, icap, near)


def ws_fields(ws, ng: int, icap: int, near: bool) -> dict:
    """The workspace's fields, after a split on the card, as int64
    tensors cut to the number of items (off[ng])."""
    names = ["unit", "off", "item_g"] + (["cov", "k0", "k1"] if near else [])
    sizes = [ng, ng + 1, icap] + ([ng, icap, icap] if near else [])
    f = dict(zip(names, (t.long() for t in torch.split(ws, sizes))))
    n_items = int(f["off"][ng])
    for k in ("item_g", "k0", "k1"):
        if k in f:
            f[k] = f[k][:n_items]
    return f


def plan_items(w, wcap: int, icap: int, p_min: int):
    """(unit, off, item_g) of weights w (ng,), each clamped to [0, wcap]:
    the item size of each group (0 without items), the first item of each
    group (off[ng] = number of items) and each item's group."""
    ng = w.shape[0]
    w = torch.clamp(w.long(), 0, wcap)
    room = icap - ng
    P = max(p_min, -(-int(torch.sum(w)) // room))
    n_it = -(-w // P)
    unit = torch.where(n_it > 0, -(-w // torch.clamp(n_it, min=1)),
                       torch.zeros_like(w))
    off = torch.cat([torch.zeros(1, dtype=torch.long, device=w.device),
                     torch.cumsum(n_it, 0)])
    item_g = torch.repeat_interleave(torch.arange(ng, device=w.device), n_it)
    return unit, off, item_g


def near_split_plain(keys, n_seg) -> dict:
    """The near kernel's items of segment keys (ng, K) with live counts
    n_seg: item i covers keys k0[i] .. k1[i]-1 of group item_g[i]; key k
    of group g belongs to item min(e_k // unit[g], items - 1), e_k the
    exclusive prefix sum of the covered counts (key & 31; 0 for IMAX), so
    that no key is split."""
    ng, K = keys.shape
    dev = keys.device
    nseg = torch.clamp(n_seg.long(), 0, K)
    col = torch.arange(K, device=dev)
    live = col[None, :] < nseg[:, None]
    cnt = torch.where(live & (keys != IMAX), keys & 31,
                      torch.zeros_like(keys)).long()
    cov = torch.sum(cnt, dim=1)
    unit, off, item_g = plan_items(cov, IMAX, item_cap(ng), NEAR_P_MIN)
    n_it = off[1:] - off[:-1]
    ex = torch.cumsum(cnt, dim=1) - cnt
    idx = torch.minimum(ex // torch.clamp(unit, min=1)[:, None],
                        torch.clamp(n_it - 1, min=0)[:, None])
    step = torch.ones_like(live)
    step[:, 1:] = idx[:, 1:] != idx[:, :-1]
    gi, k0 = torch.nonzero(live & step & (n_it > 0)[:, None], as_tuple=True)
    k1 = torch.cat([k0[1:], k0.new_zeros(1)])[:k0.shape[0]]
    last = torch.ones_like(gi, dtype=torch.bool)
    last[:-1] = gi[1:] != gi[:-1]
    k1 = torch.where(last, nseg[gi], k1)
    return dict(cov=cov, unit=unit, off=off, item_g=item_g, k0=k0, k1=k1)


def far_split_plain(nf, LF: int) -> dict:
    """The far kernel's items of lists with live counts nf (ng,) under the
    cap LF: item i covers entries e0[i] .. e1[i]-1 of group item_g[i]."""
    return far_items(nf, LF, *plan_items(nf, LF, item_cap(nf.shape[0]),
                                         FAR_E_MIN))


def far_items(nf, LF: int, unit, off, item_g) -> dict:
    """A far split's fields with each item's entry range (e0, e1): item j
    of a group covers its entries j*unit .. min((j+1)*unit, nf) - 1."""
    e0 = (torch.arange(item_g.shape[0], device=nf.device)
          - off[item_g]) * unit[item_g]
    w = torch.clamp(nf.long(), 0, LF)[item_g]
    return dict(unit=unit, off=off, item_g=item_g, e0=e0,
                e1=torch.minimum(e0 + unit[item_g], w))


def sum_items(part, off):
    """The second pass: per group, its items' partials (items, 64, 4)
    added in item order."""
    ng = off.shape[0] - 1
    out = torch.zeros((ng,) + tuple(part.shape[1:]), dtype=part.dtype,
                      device=part.device)
    n_it = off[1:] - off[:-1]
    for j in range(int(n_it.max()) if ng else 0):
        g = torch.nonzero(n_it > j, as_tuple=True)[0]
        out[g] += part[off[g] + j]
    return out
