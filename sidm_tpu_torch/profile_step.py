"""Where the time of a step goes on the card (N = 1e6 NFW halo, the
flagship's cached-list cadence).

    python -m sidm_tpu_torch.profile_step [--n 1000000] [--trace DIR]
                                          [--cadence 16,8,4,2]
                                          [--dsmc-cadence 16,8,4]

Prints, beside the card's name and power limit:
  * per walk level, the far kernel in walk mode, its far field (far_list
    on the level's compacted far ids) and the near kernel on a walk, and
    the far kernel in record mode on a recording walk of the same tree, at
    the main
    path's shapes (all groups), their plain PyTorch versions' times at the
    same shapes (CUDA events; the far kernel's own time is its device time
    by torch.profiler, ``device_ms``, beside the call's time by CUDA
    events, which its host launch time exceeds), and each call's bound
    (``bounds.py``: the least time the card could take for the same work,
    and whether bytes or operations set it; for the far kernel also the
    bound of the former dense-plane contract), with the pair and node
    counts it is computed from;
  * the list evaluation's kernels at the main path's shapes: far_list,
    near_level on the recorded keys, gather_nodes building the compact
    table from the tree (beside pack_tree + flat_tables + index_select)
    and gather_rows on the packed table (beside one ``index_select``),
    against their plain versions, with their bounds; the share of the near
    pairs inside the softening length (the near kernel's slower branch);
  * for a list step and a record step of the Simulation, and for a
    refresh and a rebuild step of the walk configuration (ListMode 0), the
    wall time (unprofiled), the device-busy time of a profiled step of the
    same kind (the device-side events summed by torch.profiler), the idle
    share (1 - busy / wall), the launches and device time of the port's
    kernels and the top device kernels. ``--trace DIR`` also writes each
    profiled step's chrome trace there; ``--steps-only`` does only this
    (and runs on earlier checkouts of the package as well);
  * for flagship-dsmc (``flagship_config(**DSMC)``, DSMC on the lists),
    the same for a list step and a record step, whose phases ``sidmrec``
    (the density clamp and the candidate record) and ``sidm`` (the DSMC
    pass) follow ``force``, and whose top kernels include the range walk,
    the emission and the gated tile; and for flagship-dsmc-walk
    (``flagship_config(**DSMC_WALK)``: the walk and DSMC on the range walk
    every step) a refresh and a rebuild step, whose ``sidm`` phase holds
    the gated windows, the range walk and the segment pass (sidm_near);
  * for each ``TreeRefreshSteps`` of ``--cadence``, 10 steps of a fresh
    Simulation in the lists' configuration with that cadence: per step its
    kind, skin, displacement, record telemetry (``ovf``, ``need``) and
    force-phase wall time; the same with DSMC on for ``--dsmc-cadence``,
    with the candidate record's telemetry and the DSMC phases.
Needs a CUDA card; it never falls back to the CPU.
"""

import argparse
import os
import subprocess
import time

import numpy as np
import torch

KERNELS = ("far_level_kernel", "range_walk_kernel", "far_list_kernel",
           "near_level_kernel", "gather_kernel", "node_rows_kernel",
           "sidm_emit_kernel", "cover_count", "sidm_gated_fill",
           "sidm_gated_kernel", "sidm_near_kernel")


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


# the device kernels of one far_level call, and of one far_list call (its
# work-item split, pass and item sums)
FAR_LEVEL_KERNELS = ("far_level_kernel",)
FAR_LIST_KERNELS = ("far_list_kernel", "items_plan", "items_fold")


def device_ms(fn, reps: int, names) -> float:
    """Device time per call of the kernels whose names contain one of
    ``names``, over ``reps`` calls of fn (torch.profiler's device events).
    Unlike a CUDA-event interval it leaves out the host's launch time,
    which is longer than a small kernel's run."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(k in e.key for k in names)) / 1e3 / reps


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


def kernel_levels(sim, card, dev):
    """Per-level far (walk and record modes), walk far field and near
    kernel times at the main path's shapes, beside their plain versions
    and bounds."""
    from .bounds import (bound_ms, far_level_dense_work, far_level_work,
                         far_list_work, near_level_work)
    from .ops.far_kernel import ListBuf, far_level, far_level_plain
    from .ops.far_list import far_list, far_list_plain
    from .ops.fused_force import default_depth
    from .ops.list_force import record_lists
    from .ops.near_kernel import near_level, near_level_plain
    from .ops.tree import build_octree
    from .ops.wq_force import wq_gravity_tree
    from .simulation import softening_table

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

    def time_level(name, level, kw):
        if name == "far_level":
            out = far_level(**kw)
            live = int(torch.sum(kw["n_live"]))
            rows.append((name, level, kw["fids"].shape,
                         device_ms(lambda: far_level(**kw), 5,
                                   FAR_LEVEL_KERNELS),
                         _cuda_ms(lambda: far_level_plain(**kw), 1),
                         far_level_work(kw, out.cnt),
                         far_level_dense_work(kw),
                         f"{live} nodes classified, call "
                         f"{_cuda_ms(lambda: far_level(**kw), 5):.3f} ms"))
            return
        nvalid = torch.sum(kw["te"] != 1.0, dim=1)  # dead slots: te = 1
        if name == "far_list":      # the walk's far field
            pairs = int(torch.sum(kw["nf"].long() * nvalid))
            rows.append(("far_list_walk", level, kw["ids"].shape,
                         device_ms(lambda: far_list(**kw), 5,
                                   FAR_LIST_KERNELS),
                         _cuda_ms(lambda: far_list_plain(**kw), 1),
                         far_list_work(kw["tbl"], kw["nf"], nvalid,
                                       kw["need_pot"]), None,
                         f"{pairs} far pairs"))
            return
        work = near_level_work(kw, nvalid)
        live = (torch.arange(kw["keys"].shape[1], device=dev)[None, :]
                < kw["n_seg"][:, None])
        cnt = torch.where(live, kw["keys"] & 31, torch.zeros_like(kw["keys"]))
        pairs = int(torch.sum(torch.sum(cnt.long(), dim=1) * nvalid))
        rows.append((name, level, kw["keys"].shape,
                     _cuda_ms(lambda: near_level(**kw), 5),
                     _cuda_ms(lambda: near_level_plain(**kw), 1), work, None,
                     f"{pairs} pairs"))

    def time_record_level(level, kw):
        # each timed launch appends the same entries again: the list counts
        # and telemetry are put back first (that copy timed alone, taken off)
        buf = ListBuf(*(t.clone() for t in kw["lists"]))
        nf, nn, st = (t.clone() for t in kw["lists"][2:])

        def restore():
            buf.nf.copy_(nf)
            buf.nn.copy_(nn)
            buf.stat.copy_(st)

        def timed(fn, reps):
            return (_cuda_ms(lambda: (restore(), fn(**dict(kw, lists=buf))),
                             reps) - _cuda_ms(restore, reps))
        out = far_level(**dict(kw, lists=buf))

        def run():
            restore()
            far_level(**dict(kw, lists=buf))
        rows.append(("far_level_record", level, kw["fids"].shape,
                     device_ms(run, 5, FAR_LEVEL_KERNELS),
                     timed(far_level_plain, 1),
                     far_level_work(kw, out.cnt), far_level_dense_work(kw),
                     f"call {timed(far_level, 5):.3f} ms"))

    wq_gravity_tree(tree, mass_t, eps, p.old_acc, theta=0.5, opening=1,
                    need_pot=False, on_level=time_level)
    record_lists(tree, p.old_acc[tree.perm], p.valid[tree.perm], theta=0.5,
                 use_relative=True, lcfg=sim._lfc, skin=sim._skin_now,
                 on_level=time_record_level)
    del tree
    torch.cuda.synchronize()
    print("kernel           level groups width  kernel_ms   plain_ms "
          "  bound_ms bound_by   dense_bound_ms  work")
    tot = {}
    for name, level, shape, ms, pms, (ops, nb), dense, note in rows:
        bms, by = bound_ms(ops, nb)
        dms = "-" if dense is None else f"{bound_ms(*dense)[0]:.4f}"
        print(f"{name:<16} {level:>5} {shape[0]:>6} {shape[1]:>5} "
              f"{ms:10.3f} {pms:10.3f} {bms:10.4f} {by:<10} {dms:>10} "
              f"{note} {ops:.4g} ops {nb:.4g} B")
        t = tot.setdefault(name, [0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
        t[0] += ms
        t[1] += pms
        t[2] += ops
        t[3] += nb
        if dense is not None:
            t[4] += dense[0]
            t[5] += dense[1]
    for name, (ms, pms, ops, nb, dops, dnb) in tot.items():
        bms, by = bound_ms(ops, nb)
        dense = "" if not dnb else \
            f", dense-plane bound {bound_ms(dops, dnb)[0]:.3f} ms"
        print(f"{name} all levels: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
              f"bound {bms:.3f} ms ({by}; {ops:.4g} ops, {nb:.4g} B){dense} "
              f"[{card}]")



def list_kernels(sim, card, dev):
    """The list evaluation's kernels at the main path's shapes."""
    from .bounds import (bound_ms, far_list_work, gather_nodes_work,
                         gather_work, near_level_work)
    from .ops.far_list import far_list, far_list_plain
    from .ops.fused_force import flat_tables, pack_tree
    from .ops.gather import (gather_nodes, gather_nodes_plain, gather_rows,
                             gather_rows_plain)
    from .ops.list_force import eval_inputs
    from .ops.near_kernel import near_level, near_level_plain

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

    def packed_gather():
        tbl = flat_tables(pack_tree(btree))
        return torch.index_select(torch.cat(
            [tbl, torch.zeros(1, 16, device=dev)]), 0, flat)
    for name, kern, plain, kw, work, lib in (
            ("far_list", far_list, far_list_plain, fkw,
             far_list_work(ctbl, lists.nf, nvalid, False), None),
            ("near_level", near_level, near_level_plain, nkw,
             near_level_work(nkw, nvalid), None),
            ("gather_nodes", gather_nodes, gather_nodes_plain,
             dict(tree=btree, ids=src),
             gather_nodes_work(btree.mac_rows.shape[0], src), packed_gather),
            ("gather_rows", gather_rows, gather_rows_plain,
             dict(tbl=tbl_all, ids=src), gather_work(tbl_all, src, False),
             lambda: torch.index_select(ext, 0, flat))):
        ms = _cuda_ms(lambda: kern(**kw), 5)
        pms = _cuda_ms(lambda: plain(**kw), 1)
        bms, by = bound_ms(*work)
        extra = "" if lib is None else \
            f", library {_cuda_ms(lib, 5):.3f} ms"
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



def list_kind(sim) -> str:
    return sim.last_list_info["kind"]


def walk_kind(sim) -> str:
    return "walk rebuild" if sim.last_step_rebuilt else "walk refresh"


def step_walls(sim, n: int, kind_of, force_last: bool) -> dict:
    """Wall time and phases of n unprofiled steps, by step kind (the last
    of each kind); with force_last the last step rebuilds."""
    walls = {}
    for i in range(n):
        if force_last and i == n - 1:
            sim._refresh_left = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        walls[kind_of(sim)] = (time.perf_counter() - t0,
                               dict(sim.last_phase_wall))
    return walls


def profiled_steps(sim, walls, kind_of, card, trace):
    """Two profiled steps, the next one and one forced to rebuild: device
    busy, idle share against the unprofiled wall of the same kind,
    launches of the port's kernels and the top device kernels."""
    from torch.profiler import ProfilerActivity, profile
    for force in (False, True):
        if force:
            sim._refresh_left = 0     # end the cycle: the next step rebuilds
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim.step()
            torch.cuda.synchronize()
        kind = kind_of(sim)
        # device-side events only: the host ops' device times repeat them
        avg = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(_device_us(e) for e in avg) / 1e6
        # "::name" so that PyTorch's vectorized_gather_kernel is not ours
        launches = {k: (sum(e.count for e in avg if "::" + k in e.key),
                        round(sum(_device_us(e) for e in avg
                                  if "::" + k in e.key) / 1e3, 4))
                    for k in KERNELS}
        wall, phases = walls[kind]
        print(f"step ({kind}): wall {wall * 1e3:.1f} ms (phases "
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in phases.items())
              + f"), device busy {busy * 1e3:.1f} ms, idle share "
              f"{1 - busy / wall:.3f}, (launches, device ms) {launches} "
              f"[{card}]")
        top = sorted(avg, key=_device_us, reverse=True)[:14]
        for e in top:
            print(f"    {_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  "
                  f"{e.key[:90]}")
        if trace:
            os.makedirs(trace, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                trace, f"step_{kind.replace(' ', '_')}.json"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=12345)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--cadence", default="16,8,4,2",
                    help="TreeRefreshSteps values to sweep ('' for none)")
    ap.add_argument("--dsmc-cadence", default="16,8,4",
                    help="TreeRefreshSteps values to sweep with DSMC on "
                    "('' for none)")
    ap.add_argument("--steps-only", action="store_true",
                    help="only the profiled list, record and walk steps "
                    "(runs on older checkouts of the package too)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")

    from .flagship import flagship_config, flagship_ics
    from .simulation import Simulation

    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    pos, vel, mass = flagship_ics(args.n, args.seed)

    def new_sim(**changes):   # a prepared Simulation of the N = 1e6 halo
        s = Simulation(flagship_config(**changes), mode="phased",
                       device=dev)
        s.set_particles_from_arrays(pos, vel, mass,
                                    np.ones(args.n, np.int32),
                                    pad_to_multiple=4096)
        s.prepare()
        return s

    sim = new_sim()
    if not args.steps_only:
        kernel_levels(sim, card, dev)
    # unprofiled steps give the wall times, profiled ones the device time:
    # after prepare's record at skin 0, step 1 evaluates the lists (and
    # trips the validity monitor), step 2 records, steps 3+ evaluate
    walls = step_walls(sim, 3, list_kind, force_last=False)
    if not args.steps_only:
        list_kernels(sim, card, dev)
    profiled_steps(sim, walls, list_kind, card, args.trace)
    del sim
    # the walk on every step (ListMode 0): refresh steps, then a rebuild
    wsim = new_sim(ListMode=0)
    walls = step_walls(wsim, 3, walk_kind, force_last=True)
    profiled_steps(wsim, walls, walk_kind, card, args.trace)
    del wsim
    if args.steps_only:
        return
    from .flagship import DSMC
    # flagship-dsmc: prepare records the candidates at skin 0; step 1 is a
    # list step, step 2 a record step
    dsim = new_sim(**DSMC)

    def dsmc_kind(sim):
        return "dsmc " + list_kind(sim)
    walls = step_walls(dsim, 3, dsmc_kind, force_last=False)
    profiled_steps(dsim, walls, dsmc_kind, card, args.trace)
    del dsim
    # flagship-dsmc-walk: the walk and the DSMC range walk every step
    from .flagship import DSMC_WALK
    wdsim = new_sim(**DSMC_WALK)

    def dsmc_walk_kind(sim):
        return "dsmc " + walk_kind(sim)
    walls = step_walls(wdsim, 3, dsmc_walk_kind, force_last=True)
    profiled_steps(wdsim, walls, dsmc_walk_kind, card, args.trace)
    del wdsim
    for k in [int(v) for v in args.dsmc_cadence.split(",") if v]:
        csim = new_sim(TreeRefreshSteps=k, **DSMC)
        for step in range(1, 11):
            csim.step()
            li, si = csim.last_list_info, csim.last_sidm_info
            md = "-" if li["md"] is None else f"{li['md']:.4f}"
            w = csim.last_phase_wall
            # a record that dropped entries gives the lists up: the walk
            # and the DSMC range walk take over
            cand = (f"candidate ovf {si['cand_ovf']} need "
                    f"{si['cand_need']}" if si["engine"] == "lists" else
                    f"DSMC on the range walk, drops {si['walk_ovf']}")
            print(f"dsmc cadence {k} step {step} ({li['kind']}"
                  + (", candidate record" if si["record"] else "")
                  + f"): skin {li['skin']:.4f}, md {md}, ovf {li['ovf']}, "
                  f"need {li['need']}, {cand}, scatters {si['n_scat']}, "
                  + ", ".join(f"{ph} {v * 1e3:.1f} ms"
                              for ph, v in w.items()) + f" [{card}]",
                  flush=True)
        del csim
    for k in [int(v) for v in args.cadence.split(",") if v]:
        csim = new_sim(TreeRefreshSteps=k)
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
