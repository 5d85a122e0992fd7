"""Where the time of a step goes on the card (N = 1e6 NFW halo, the
flagship's cached-list cadence).

    python -m sidm_tpu_torch.profile_step [--n 1000000] [--trace DIR]
                                          [--cadence 16,8,4,2]

Prints, beside the card's name and power limit:
  * per walk level, the far kernel in both modes (the lists' record walk
    and the walk's far field) and the near kernel at the main path's shapes
    (all groups), their plain PyTorch versions' times at the same shapes
    (CUDA events), and each call's bound (``bounds.py``: the least time the
    card could take for the same work, and whether bytes or operations set
    it), with the pair and node counts it is computed from;
  * the list evaluation's kernels at the main path's shapes: far_list,
    near_level on the recorded keys, gather_rows building the compact
    table, against their plain versions (and, for the gather, one
    ``index_select``), with their bounds; the share of the near pairs
    inside the softening length (the near kernel's slower branch);
  * for a list step and a record step of the Simulation, the wall time
    (unprofiled), the device-busy time of a profiled step of the same kind
    (the device-side events summed by torch.profiler), the idle share
    (1 - busy / wall), the launches of the port's kernels and the top
    device kernels. ``--trace DIR`` also writes each profiled step's
    chrome trace there;
  * for each ``TreeRefreshSteps`` of ``--cadence``, 10 steps of a fresh
    Simulation in the lists' configuration with that cadence: per step its
    kind, skin, displacement, record telemetry (``ovf``, ``need``) and
    force-phase wall time.
Needs a CUDA card; it never falls back to the CPU.
"""

import argparse
import os
import subprocess
import time

import numpy as np
import torch

KERNELS = ("far_level_kernel", "far_list_kernel", "near_level_kernel",
           "gather_kernel")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _cuda_ms(fn, reps: int) -> float:
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


SOFT_GROUPS = 256


def near_soft_share(lists, tree, gt, te):
    """(pairs inside the softening length, pairs) of the near lists'
    (valid target, covered particle) pairs, over SOFT_GROUPS groups."""
    dev = gt.device
    slot = torch.arange(32, device=dev)
    soft = pairs = 0
    ng = lists.nn.shape[0]
    for g in torch.linspace(0, ng - 1, min(SOFT_GROUPS, ng)).long().tolist():
        k = lists.near[g, :int(lists.nn[g])].long()
        idx = (k[:, None] >> 5) + slot
        p = torch.clamp(idx[slot[None, :] < (k[:, None] & 31)],
                        max=tree.pos_s.shape[0] - 1)
        v = lists.gvalid[g]
        r = torch.linalg.norm(gt[g][v][:, None, :] - tree.pos_s[p][None],
                              dim=-1)
        h = 2.8 * torch.maximum(te[g][v][:, None], tree.eps_s[p][None])
        soft += int(torch.sum(r < h))
        pairs += r.numel()
    return soft, pairs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=12345)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--cadence", default="16,8,4,2",
                    help="TreeRefreshSteps values to sweep ('' for none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")

    from .bounds import (bound_ms, far_level_work, far_list_work,
                         gather_work, near_level_work)
    from .flagship import flagship_config, flagship_ics
    from .ops.far_kernel import far_level, far_level_plain
    from .ops.far_list import far_list, far_list_plain
    from .ops.fused_force import default_depth, pack_tree
    from .ops.gather import gather_rows, gather_rows_plain
    from .ops.list_force import eval_inputs, flat_tables
    from .ops.near_kernel import near_level, near_level_plain
    from .ops.tree import build_octree
    from .ops.wq_force import wq_gravity_tree
    from .simulation import Simulation, softening_table

    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    pos, vel, mass = flagship_ics(args.n, args.seed)
    sim = Simulation(flagship_config(), mode="phased", device=dev)
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(args.n, np.int32),
                                  pad_to_multiple=4096)
    sim.prepare()

    # per-level kernels vs plain at the main path's shapes: the walk of the
    # next step's particles, observed level by level
    rows = []
    p = sim.particles
    soft = torch.as_tensor(softening_table(sim.cfg, sim.time),
                           dtype=torch.float32, device=dev)
    eps = soft[torch.clamp(p.ptype, 0, 5).long()]
    mass_t = torch.where(p.valid, p.mass, torch.zeros_like(p.mass))
    tree = build_octree(p.pos, mass_t, eps, p.valid,
                        depth=default_depth(p.n_padded), uniform_eps=True)
    offs = tree.level_offsets

    def time_level(name, level, kw):
        nvalid = torch.sum(kw["te"] != 1.0, dim=1)  # dead slots: te = 1
        if name == "far_level":
            rkw = dict(kw, xc=None, te=None, record=True,
                       lvl_base=offs[level])
            fark = far_level(**rkw)[0]
            work = far_level_work(rkw, fark, nvalid)
            rows.append(("far_level_record", level, kw["fids"].shape,
                         _cuda_ms(lambda: far_level(**rkw), 5),
                         _cuda_ms(lambda: far_level_plain(**rkw), 1), work,
                         ""))
            work = far_level_work(kw, fark, nvalid)
            pairs = int(torch.sum(torch.sum(fark != 2147483647, dim=1)
                                  * nvalid))
            kern, plain, shape = far_level, far_level_plain, kw["fids"].shape
        else:
            work = near_level_work(kw, nvalid)
            live = (torch.arange(kw["keys"].shape[1], device=dev)[None, :]
                    < kw["n_seg"][:, None])
            cnt = torch.where(live, kw["keys"] & 31,
                              torch.zeros_like(kw["keys"]))
            pairs = int(torch.sum(torch.sum(cnt.long(), dim=1) * nvalid))
            kern, plain, shape = near_level, near_level_plain, \
                kw["keys"].shape
        rows.append((name, level, shape, _cuda_ms(lambda: kern(**kw), 5),
                     _cuda_ms(lambda: plain(**kw), 1), work,
                     f"{pairs} pairs"))

    wq_gravity_tree(tree, mass_t, eps, p.old_acc, theta=0.5, opening=1,
                    need_pot=False, on_level=time_level)
    del tree
    torch.cuda.synchronize()
    print("kernel           level groups width  kernel_ms   plain_ms "
          "  bound_ms bound_by   work")
    tot = {}
    for name, level, shape, ms, pms, (ops, nb), note in rows:
        bms, by = bound_ms(ops, nb)
        print(f"{name:<16} {level:>5} {shape[0]:>6} {shape[1]:>5} "
              f"{ms:10.3f} {pms:10.3f} {bms:10.4f} {by:<10} {note} "
              f"{ops:.4g} ops {nb:.4g} B")
        t = tot.setdefault(name, [0.0, 0.0, 0.0, 0.0])
        t[0] += ms
        t[1] += pms
        t[2] += ops
        t[3] += nb
    for name, (ms, pms, ops, nb) in tot.items():
        bms, by = bound_ms(ops, nb)
        print(f"{name} all levels: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
              f"bound {bms:.3f} ms ({by}; {ops:.4g} ops, {nb:.4g} B) "
              f"[{card}]")

    # unprofiled steps give the wall times, profiled ones the device time:
    # after prepare's record at skin 0, step 1 evaluates the lists (and
    # trips the validity monitor), step 2 records, steps 3+ evaluate
    walls = {}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        walls[sim.last_list_info["kind"]] = (time.perf_counter() - t0,
                                             dict(sim.last_phase_wall))
    # the list evaluation's kernels at the main path's shapes: the lists
    # recorded under the learned skin
    lists, btree = sim._lists_cache, sim._tree_cache
    ctbl, gt, xc, te, gc = eval_inputs(btree, lists)
    nvalid = torch.sum(lists.gvalid, dim=1)
    fkw = dict(tbl=ctbl, ids=lists.far, nf=lists.nf, xc=xc, te=te, gc=gc,
               need_pot=False)
    nkw = dict(keys=lists.near, n_seg=lists.nn, pos_s=btree.pos_s,
               mass_s=btree.mass_s, eps_s=btree.eps_s, xr=gt, te=te,
               need_pot=False)
    tbl_all = flat_tables(pack_tree(btree))
    src = torch.cat([lists.src, torch.full((1,), tbl_all.shape[0],
                                           dtype=torch.int32, device=dev)])
    ext = torch.cat([tbl_all, torch.zeros(1, 16, device=dev)])
    flat = src.long()
    for name, kern, plain, kw, work, lib in (
            ("far_list", far_list, far_list_plain, fkw,
             far_list_work(ctbl, lists.nf, nvalid, False), None),
            ("near_level", near_level, near_level_plain, nkw,
             near_level_work(nkw, nvalid), None),
            ("gather_rows", gather_rows, gather_rows_plain,
             dict(tbl=tbl_all, ids=src), gather_work(tbl_all, src, False),
             lambda: torch.index_select(ext, 0, flat))):
        ms = _cuda_ms(lambda: kern(**kw), 5)
        pms = _cuda_ms(lambda: plain(**kw), 1)
        bms, by = bound_ms(*work)
        extra = "" if lib is None else \
            f", index_select {_cuda_ms(lib, 5):.3f} ms"
        print(f"list eval {name}: kernel {ms:.3f} ms, plain {pms:.3f} ms"
              f"{extra}, bound {bms:.3f} ms ({by}; {work[0]:.4g} ops, "
              f"{work[1]:.4g} B) [{card}]")
    soft, pairs = near_soft_share(lists, btree, gt, te)
    print(f"near pairs inside the softening length (r < 2.8 max(eps), "
          f"{SOFT_GROUPS} groups of the lists): {soft} of {pairs}, "
          f"{soft / pairs:.4f}")
    print(f"lists: groups {lists.nf.shape[0]}, far entries "
          f"{int(lists.nf.sum())} (max {int(lists.nf.max())}), near entries "
          f"{int(lists.nn.sum())} (max {int(lists.nn.max())}), used nodes "
          f"{lists.need.tolist()[2]}, far pairs "
          f"{int(torch.sum(lists.nf.long() * nvalid))}")
    del lists, btree, ctbl, gt, xc, te, gc, tbl_all, src, ext, flat, fkw, nkw

    from torch.profiler import ProfilerActivity, profile
    for force_record in (False, True):
        if force_record:
            sim._refresh_left = 0     # end the cycle: the next step records
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim.step()
            torch.cuda.synchronize()
        kind = sim.last_list_info["kind"]
        # device-side events only: the host ops' device times repeat them
        avg = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(_device_us(e) for e in avg) / 1e6
        launches = {k: sum(e.count for e in avg if k in e.key)
                    for k in KERNELS}
        wall, phases = walls[kind]
        print(f"step ({kind}): wall {wall * 1e3:.1f} ms (phases "
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in phases.items())
              + f"), device busy {busy * 1e3:.1f} ms, idle share "
              f"{1 - busy / wall:.3f}, launches {launches} [{card}]")
        top = sorted(avg, key=_device_us, reverse=True)[:14]
        for e in top:
            print(f"    {_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  "
                  f"{e.key[:90]}")
        if args.trace:
            os.makedirs(args.trace, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.trace,
                                                  f"step_{kind}.json"))

    del sim
    for k in [int(v) for v in args.cadence.split(",") if v]:
        csim = Simulation(flagship_config(TreeRefreshSteps=k), mode="phased",
                          device=dev)
        csim.set_particles_from_arrays(pos, vel, mass,
                                       np.ones(args.n, np.int32),
                                       pad_to_multiple=4096)
        csim.prepare()
        for step in range(1, 11):
            csim.step()
            li = csim.last_list_info
            md = "-" if li["md"] is None else f"{li['md']:.4f}"
            print(f"cadence {k} step {step} ({li['kind']}): skin "
                  f"{li['skin']:.4f}, md {md}, ovf {li['ovf']}, need "
                  f"{li['need']}, force "
                  f"{csim.last_phase_wall['force'] * 1e3:.1f} ms [{card}]",
                  flush=True)
        del csim


if __name__ == "__main__":
    main()
