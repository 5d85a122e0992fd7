"""Smoke test of the PyTorch port (sidm_tpu_torch) on one CUDA card.

Run from the root of a checkout on a machine with an H100:

    python3 chip_smoke.py            # N = 1e6 flagship halo

Phases (each asserts; any failure exits non-zero):
  1. card: name and power limit from nvidia-smi;
  2. build: compile the CUDA kernels from csrc/, one nvcc per source, all
     in parallel (timed);
  3. walk kernels vs plain: on real frontiers of a shallow, a deep and the
     last level of the N = 1e6 NFW tree, for a subset of groups, far_level
     in both modes (walk: p99.9 relative error < 2e-5 and identical keys;
     record: all four key planes identical) and near_level against their
     plain PyTorch versions, with times of both; near_level timed on every
     level of the walk for all groups (its time per walk, with its bound)
     and held against its plain version on all groups of the level with
     the most segments;
  4. oracles: the walk, and the cached lists recorded at skin 0 on the same
     fresh tree, at N = 1e6 (theta 0.5, geometric opening) against the
     direct sum on 4096 random targets (p99 <= 1e-3);
  5. main path: bench.py's configuration with SIDMOn 0, TreeWalkEngine wq,
     ListMode 1 through Simulation: prepare, 8 steps, compute_potential;
     >= 2 record steps (prepare's included), >= 4 list steps, no list or
     walk overflow, finite positions, |dE/E| < 1e-3, and launches of
     far_level (record), far_list, near_level and gather_rows;
  6. list kernels vs plain: far_list and near_level on the main path's
     recorded lists, for 512 groups (timed against the plain versions) and
     for all groups (timed, with the bound), with and without the
     potential (p99.9 relative error < 2e-5, finite), their work items on
     all groups equal to the plain split; stress inputs at
     the same bars (far: two lists at far_cap, one with dead ids, beside
     empty lists; near: a group at the near cap of K keys of cnt 31 beside
     empty groups, self and coincident pairs); gather_rows bit-equal at the
     compact table's shape;
  7. the TPU probes' shapes: far_list through the Pallas far prototype's
     interface (NU = 2048 units) against its XLA reference (max |diff| /
     max |ref| < 1e-5), gather_rows bit-equal at (65536, 16) x 256 x 2048
     ids, gather_rowsum at 8M ids from (2^14, 16) and (2^10, 16);
  8. first slice's path: ListMode 0 (the walk every step) through
     Simulation: prepare, 2 steps, compute_potential, with far_level and
     near_level launched, no overflow, |dE/E| < 1e-3.
Before the last line it prints one JSON object with the per-kernel results
(``launches``: on this slice's main path, phase 5; ``launches_by_path``:
phase 5's and phase 8's counts, each path's counters set to 0 just before
it and read just after; for far_list and near_level ``full_ms`` and
``full_bound_ms`` on all groups of the lists, for near_level ``walk_ms``
and ``walk_bound_ms`` per walk) and the card's name and power limit; the
last line is {"ok": true, "device": {...}}.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 12345
STEPS = 8              # list path, after prepare
WALK_STEPS = 2         # first slice's path, after prepare
ORACLE_TARGETS = 4096  # random targets held against the direct sum
SUBSET_GROUPS = 512    # groups per call in the kernel-vs-plain checks
K3_UNITS = 2048        # scripts/pallasfar.py NU
K6_CAP, K6_BLOCKS, K6_IDS = 65536, 256, 2048   # pallas_gather_probe.py
K45_IDS = 1 << 23      # scripts/gatherbench.py F


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def rel_err(a, b, valid):
    """Per-target |a-b|/|b| of [ax ay az] and |pot_a-pot_b|/|pot_b|."""
    va, vb = a[..., :3][valid], b[..., :3][valid]
    e = torch.linalg.norm(va - vb, dim=-1) / torch.clamp(
        torch.linalg.norm(vb, dim=-1), min=1e-30)
    pa, pb = a[..., 3][valid], b[..., 3][valid]
    ep = torch.abs(pa - pb) / torch.clamp(torch.abs(pb), min=1e-30)
    return e, ep


def q999(x) -> float:
    return float(torch.quantile(x.float(), 0.999)) if x.numel() else 0.0


class Results:
    """Per-kernel sums of what this run measured, for the JSON line."""

    def __init__(self):
        self.rows = {}

    def add(self, name, max_abs, ms, plain_ms, ops, nbytes, library_ms=None):
        r = self.rows.setdefault(name, dict(max_abs_err=0.0, ms=0.0,
                                            plain_ms=0.0, ops=0.0, bytes=0.0,
                                            library_ms=None))
        r["max_abs_err"] = max(r["max_abs_err"], float(max_abs))
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["ops"] += ops
        r["bytes"] += nbytes
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library_ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="particles (the check is made for 1e6)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port on the card only")
    # imported only now: the script alone, without the package, must fail
    from sidm_tpu_torch import _build
    from sidm_tpu_torch.bounds import (bound_ms, far_level_work,
                                       far_list_work, gather_work,
                                       near_level_work)
    from sidm_tpu_torch.flagship import flagship_config, flagship_ics
    from sidm_tpu_torch.ops.direct import direct_gravity
    from sidm_tpu_torch.ops.far_kernel import far_level, far_level_plain
    from sidm_tpu_torch.ops.far_list import (far_list, far_list_plain,
                                             far_split, far_units,
                                             k3_reference, units_to_lists)
    from sidm_tpu_torch.ops.work_items import (far_split_plain,
                                               near_split_plain)
    from sidm_tpu_torch.ops.fused_force import default_depth, pack_tree
    from sidm_tpu_torch.ops.gather import (gather_rows, gather_rows_plain,
                                           gather_rowsum,
                                           gather_rowsum_plain)
    from sidm_tpu_torch.ops.list_force import (eval_inputs, eval_lists,
                                               flat_tables, record_lists)
    from sidm_tpu_torch.ops.near_kernel import (near_level, near_level_plain,
                                                near_split)
    from sidm_tpu_torch.ops.tree import build_octree
    from sidm_tpu_torch.ops.wq_force import wq_gravity_tree
    from sidm_tpu_torch.simulation import Simulation

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)
    res = Results()

    # ---- build ------------------------------------------------------------
    t0 = time.perf_counter()
    info = _build.kernels_lib().build_info
    print(f"build: {time.perf_counter() - t0:.2f} s wall (parallel nvcc "
          f"{info['seconds']:.2f} s) -> "
          + ", ".join(p.name for p in info["paths"].values())
          + f" [{card}]", flush=True)
    for line in info["log"].splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- the N = 1e6 NFW halo (bench.py's ICs), padded as the main path ---
    n = args.n
    pos, vel, mass = flagship_ics(n, SEED)
    sim = Simulation(flagship_config(), mode="phased", device=dev)
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(n, np.int32),
                                  pad_to_multiple=4096)
    p = sim.particles
    mass_t = torch.where(p.valid, p.mass, torch.zeros_like(p.mass))
    eps_t = sim._softening()[torch.clamp(p.ptype, 0, 5).long()]
    old0 = torch.zeros_like(mass_t)

    # ---- walk kernels vs plain on real frontiers of the first tree ---------
    depth = default_depth(p.n_padded)
    tree = build_octree(p.pos, mass_t, eps_t, p.valid, depth=depth,
                        uniform_eps=sim._check_uniform_eps())
    offs = tree.level_offsets
    levels = {3, (3 + depth) // 2 + 1, depth, depth + 1}
    captured = {}
    sub = None
    walk_near = dict(calls=0, groups=0, ms=0.0, ops=0.0, bytes=0.0)

    def capture(name, level, kw):
        nonlocal sub
        if name == "near_level":     # every level, all groups
            nv = torch.sum(kw["te"] != 1.0, dim=1)
            ops, nb = near_level_work(kw, nv)
            walk_near["calls"] += 1
            walk_near["groups"] = kw["xr"].shape[0]
            walk_near["ms"] += cuda_ms(lambda: near_level(**kw), 3)
            walk_near["ops"] += ops
            walk_near["bytes"] += nb
            seg = int(torch.sum(kw["n_seg"]))
            if seg > walk_near.get("seg", -1):   # the level checked in full
                walk_near.update(seg=seg, level=level, kw={
                    k: (v.clone() if isinstance(v, torch.Tensor) else v)
                    for k, v in kw.items() if k != "need_pot"})
        if level not in levels:
            return
        ng = kw["xr" if name == "near_level" else "xc"].shape[0]
        if sub is None:
            sub = torch.linspace(0, ng - 1, min(SUBSET_GROUPS, ng),
                                 device=dev).long()
        captured[(name, level)] = {
            k: (v[sub].contiguous() if isinstance(v, torch.Tensor)
                and v.dim() > 0 and v.shape[0] == ng else v)
            for k, v in kw.items()}

    acc_w, _, winfo = wq_gravity_tree(
        tree, mass_t, eps_t, old0, theta=0.5, opening=1, need_pot=True,
        return_info=True, on_level=capture)
    torch.cuda.synchronize()
    wbound, wby = bound_ms(walk_near["ops"], walk_near["bytes"])
    walk_near["bound_ms"] = wbound
    print(f"kernel near_level (one walk, all {walk_near['groups']} groups, "
          f"{walk_near['calls']} calls): kernel {walk_near['ms']:.3f} ms per "
          f"walk, bound {wbound:.3f} ms ({wby}), at "
          f"{wbound / walk_near['ms']:.1%} of the bound's speed [{card}]",
          flush=True)
    n_far = n_near = 0
    for (name, level), kw in sorted(captured.items()):
        valid = kw["te"] != 1.0   # dead target slots carry te = 1
        nvalid = torch.sum(valid, dim=1)
        if name == "far_level":
            rkw = dict(kw, xc=None, te=None, record=True,
                       lvl_base=offs[level])
            rec_k = far_level(**rkw)
            rec_p = far_level_plain(**rkw)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(rec_k, rec_p)), \
                ("far_level record", level)
            r_ms = cuda_ms(lambda: far_level(**rkw), 10)
            r_plain = cuda_ms(lambda: far_level_plain(**rkw), 2)
            ops, nb = far_level_work(rkw, rec_k[0], nvalid)
            res.add("far_level_record", 0, r_ms, r_plain, ops, nb)
            print(f"kernel far_level (record) level {level}: groups "
                  f"{nvalid.shape[0]}, four key planes equal, far keys "
                  f"{int(torch.sum(rec_k[0] != 2147483647))}, kernel "
                  f"{r_ms:.3f} ms, plain {r_plain:.3f} ms [{card}]",
                  flush=True)
        kern, plain = ((far_level, far_level_plain) if name == "far_level"
                       else (near_level, near_level_plain))
        out_k = kern(**kw)
        torch.cuda.synchronize()
        out_p = plain(**kw)
        torch.cuda.synchronize()
        acc_k = out_k[0] if name == "far_level" else out_k
        acc_p = out_p[0] if name == "far_level" else out_p
        e, ep = rel_err(acc_k, acc_p, valid)
        keys = ""
        if name == "far_level":
            assert all(torch.equal(a, b) for a, b in zip(out_k[1:],
                                                         out_p[1:]))
            # the record mode's segment/open/big planes are the walk's
            assert all(torch.equal(a, b) for a, b in zip(out_k[1:],
                                                         rec_k[1:]))
            keys = "keys equal (and equal to record mode's), "
            ops, nb = far_level_work(kw, rec_k[0], nvalid)
            n_far += 1
        else:
            ops, nb = near_level_work(kw, nvalid)
            n_near += 1
        max_abs = float(torch.max(torch.abs(acc_k - acc_p)[valid]))
        ms = cuda_ms(lambda: kern(**kw), 10)
        plain_ms = cuda_ms(lambda: plain(**kw), 2)
        print(f"kernel {name} level {level}: groups {acc_k.shape[0]}, "
              f"p99.9 acc err {q999(e):.3e}, p99.9 pot err {q999(ep):.3e}, "
              f"max abs {max_abs:.3e}, {keys}"
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms(ops, nb)[0]:.3f} ms [{card}]", flush=True)
        assert q999(e) < 2e-5 and q999(ep) < 2e-5, (name, level)
        res.add(name, max_abs, ms, plain_ms, ops, nb)
    assert n_far == 3 and n_near == 4, (n_far, n_near)
    # all groups of the walk level with the most segments
    wkw = walk_near.pop("kw")
    wvalid = wkw["te"] != 1.0
    werr, wmax, outs = compare(near_level, near_level_plain, wkw, wvalid)
    print(f"kernel near_level level {walk_near['level']} (all "
          f"{wvalid.shape[0]} groups, {walk_near['seg']} segments): p99.9 acc "
          f"err {werr[0]:.3e} (with pot {werr[1]:.3e}, pot {werr[2]:.3e}), "
          f"max abs {wmax:.3e} [{card}]", flush=True)
    assert max(werr) < 2e-5, werr
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    del wkw, outs

    # ---- oracles: the walk and the lists at N = 1e6 vs the direct sum -------
    g = torch.Generator().manual_seed(SEED)
    tgt = torch.randperm(n, generator=g)[:ORACLE_TARGETS].to(dev)
    acc_d, _ = direct_gravity(p.pos, mass_t, eps_t, targets=tgt,
                              with_potential=False)
    t0 = time.perf_counter()
    acc_o, _, oinfo = wq_gravity_tree(tree, mass_t, eps_t, old0, theta=0.5,
                                      opening=0, need_pot=False,
                                      return_info=True)
    torch.cuda.synchronize()
    t_walk = time.perf_counter() - t0
    t0 = time.perf_counter()
    lists0 = record_lists(tree, old0[tree.perm], p.valid[tree.perm],
                          theta=0.5, use_relative=False, lcfg=sim._lfc,
                          skin=0.0)
    acc_l, _ = eval_lists(tree, lists0, mass_t, eps_t, need_pot=False)
    torch.cuda.synchronize()
    t_list = time.perf_counter() - t0
    lovf = lists0.ovf.tolist()
    for label, acc_x, extra in (
            ("walk", acc_o, f"walk {t_walk:.3f} s, ovf_open "
             f"{int(oinfo['ovf_open'])} ovf_big {int(oinfo['ovf_big'])}"),
            ("lists", acc_l, f"record + eval {t_list:.3f} s, ovf {lovf}")):
        e = torch.linalg.norm(acc_x[tgt] - acc_d, dim=1) / torch.linalg.norm(
            acc_d, dim=1)
        p99 = float(torch.quantile(e, 0.99))
        print(f"oracle ({label}): N {n} ({p.n_padded} padded), "
              f"{ORACLE_TARGETS} targets, p99 {p99:.3e}, max "
              f"{float(e.max()):.3e}, {extra} [{card}]", flush=True)
        assert p99 <= 1e-3, (label, p99)
    assert sum(lovf) == 0, lovf
    del acc_o, acc_d, acc_l, acc_w, lists0, tree

    # ---- main path: the list-mode Simulation on the card --------------------
    counters = {"far_level": (far_level, "launches"),
                "far_level_record": (far_level, "record_launches"),
                "near_level": (near_level, "launches"),
                "far_list": (far_list, "launches"),
                "gather_rows": (gather_rows, "launches"),
                "gather_rowsum": (gather_rowsum, "launches")}

    def zero_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counts():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    zero_counts()
    t0 = time.perf_counter()
    sim.prepare()
    infos = [dict(sim.last_list_info)]
    sim.compute_potential()
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    e_start = sim_energy(sim)
    ovf, walls = 0, []
    t0 = time.perf_counter()
    for _ in range(STEPS):
        sim.step()
        li = dict(sim.last_list_info)
        infos.append(li)
        if li["ovf"] is not None:
            ovf += sum(li["ovf"])
        if sim.last_walk_info is not None:
            ovf += sum(int(sim.last_walk_info[k]) for k in
                       ("ovf_open", "ovf_big", "ovf_items"))
        walls.append((li, dict(sim.last_phase_wall)))
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    sim.compute_potential()
    torch.cuda.synchronize()
    launches = read_counts()
    e_end = sim_energy(sim)
    de = abs(e_end - e_start) / abs(e_start)
    finite = bool(torch.isfinite(sim.particles.pos).all())
    rate = n * STEPS / t_steps
    kinds = [i["kind"] for i in infos]
    for k, (li, w) in enumerate(walls):
        md = "-" if li["md"] is None else f"{li['md']:.4g}"
        print(f"step {k + 1} ({li['kind']}): "
              + ", ".join(f"{ph} {s * 1e3:.1f} ms" for ph, s in w.items())
              + f", skin {li['skin']:.4g}, md {md}"
              + ("" if li["ovf"] is None else
                 f", ovf {li['ovf']}, need {li['need']}") + f" [{card}]")
    print(f"main path (ListMode 1): N {n}, prepare+potential {t_prep:.2f} s, "
          f"{STEPS} steps {t_steps:.3f} s, {rate:.1f} particle-steps/s, "
          f"kinds {kinds}, t = {sim.time:.6g}, |dE/E| {de:.3e}, launches "
          f"{launches}, overflow {ovf}, finite {finite}, diag far "
          f"{sim._diag_far} near {sim._diag_near} [{card}]", flush=True)
    assert finite and ovf == 0 and de < 1e-3, (finite, ovf, de)
    assert kinds.count("record") >= 2 and kinds.count("list") >= 4, kinds
    for key in ("far_level_record", "far_list", "near_level",
                "gather_rows"):
        assert launches[key] > 0, (key, launches)

    # ---- list kernels vs plain on the main path's recorded lists ------------
    lists, btree = sim._lists_cache, sim._tree_cache
    ctbl, gt, xc, te, gc = eval_inputs(btree, lists)
    ng = lists.nf.shape[0]
    sub = torch.linspace(0, ng - 1, min(SUBSET_GROUPS, ng), device=dev).long()
    nvalid = torch.sum(lists.gvalid, dim=1)
    fkw = dict(tbl=ctbl, ids=lists.far, nf=lists.nf, xc=xc, te=te, gc=gc)
    nkw = dict(keys=lists.near, n_seg=lists.nn, pos_s=btree.pos_s,
               mass_s=btree.mass_s, eps_s=btree.eps_s, xr=gt, te=te)
    for name, kern, plain, kw, work, count in (
            ("far_list", far_list, far_list_plain, fkw,
             lambda k, nv: far_list_work(ctbl, k["nf"], nv, False),
             f"entries {int(lists.nf.sum())}"),
            ("near_level", near_level, near_level_plain, nkw,
             lambda k, nv: near_level_work(dict(k, need_pot=False), nv),
             f"segments {int(lists.nn.sum())}")):
        skw = {k: (v[sub].contiguous() if k not in ("tbl", "pos_s", "mass_s",
                                                    "eps_s") else v)
               for k, v in kw.items()}
        serr, smax, _ = compare(kern, plain, skw, lists.gvalid[sub])
        ms = cuda_ms(lambda: kern(**skw, need_pot=False), 10)
        plain_ms = cuda_ms(lambda: plain(**skw, need_pot=False), 2)
        ops, nb = work(skw, nvalid[sub])
        # all groups: the kernels' plan depends on the number of groups
        ferr, fmax, outs = compare(kern, plain, kw, lists.gvalid)
        full_ms = cuda_ms(lambda: kern(**kw, need_pot=False), 5)
        fbound, fby = bound_ms(*work(kw, nvalid))
        print(f"kernel {name} (main path lists): groups {len(sub)} of {ng}, "
              f"p99.9 acc err {serr[0]:.3e} (with pot {serr[1]:.3e}, pot "
              f"{serr[2]:.3e}), max abs {smax:.3e}, kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms(ops, nb)[0]:.3f} ms; all "
              f"{ng} groups, {count}: p99.9 acc err {ferr[0]:.3e} (with pot "
              f"{ferr[1]:.3e}, pot {ferr[2]:.3e}), max abs {fmax:.3e}, kernel "
              f"{full_ms:.3f} ms, bound {fbound:.3f} ms ({fby}), at "
              f"{fbound / full_ms:.1%} of the bound's speed [{card}]",
              flush=True)
        assert max(serr + ferr) < 2e-5, (name, serr, ferr)
        assert all(bool(torch.isfinite(o).all()) for o in outs), name
        res.add(name, max(smax, fmax), ms, plain_ms, ops, nb)
        res.rows[name].update(full_ms=full_ms, full_bound_ms=fbound)
    res.rows["near_level"].update(walk_ms=walk_near["ms"],
                                  walk_bound_ms=walk_near["bound_ms"])
    check_split("far_list", far_split(lists.nf, lists.far.shape[1]),
                far_split_plain(lists.nf, lists.far.shape[1]), card)
    check_split("near_level", near_split(lists.near, lists.nn),
                near_split_plain(lists.near, lists.nn), card)

    # ---- stress: the caps beside empty groups, self and coincident pairs ---
    far_stress(res, lists, ctbl, xc, te, gc, card)
    near_stress(res, lists, btree, gt, te, card)

    tbl_all = flat_tables(pack_tree(btree))
    src = torch.cat([lists.src, torch.full((1,), tbl_all.shape[0],
                                           dtype=torch.int32, device=dev)])
    check_gather(res, "gather_rows", gather_rows, gather_rows_plain, tbl_all,
                 src, "compact table", card, gather_work, bound_ms)
    del lists, btree, ctbl, gt, xc, te, gc, tbl_all, src, sim, fkw, nkw

    # ---- the TPU probes' own shapes -------------------------------------
    # make_chunk's data as the script's main() draws it (seed 0): random
    # quadrupoles make the function jump where a pair crosses r = h (the
    # quadrupole is Newtonian-range only), and this draw has no pair within
    # rounding of that edge
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((K3_UNITS * 32, 16)).astype(np.float32)
    rows[:, 3] = np.abs(rows[:, 3])
    rows[:, 14] = 1.0 / 0.3
    rng.integers(0, 16384, K3_UNITS)   # make_chunk's unit group ids
    tgt_k3 = rng.standard_normal((K3_UNITS, 256)).astype(np.float32)
    tgt_k3[:, 192:] = 1.0 / 0.3
    rows, tgt_k3 = torch.tensor(rows, device=dev), torch.tensor(tgt_k3,
                                                                device=dev)
    ref = k3_reference(rows, tgt_k3)
    out = far_units(rows, tgt_k3)
    diffs = [float(torch.max(torch.abs(a - r)) / torch.max(torch.abs(r)))
             for a, r in zip(out, ref)]
    ms = cuda_ms(lambda: far_units(rows, tgt_k3), 10)
    k3_in = units_to_lists(rows, tgt_k3)
    plain_ms = cuda_ms(lambda: far_list_plain(*k3_in, need_pot=True), 3)
    ref_ms = cuda_ms(lambda: k3_reference(rows, tgt_k3), 3)
    k3 = far_list_work(rows, torch.full((K3_UNITS,), 32, device=dev),
                       torch.full((K3_UNITS,), 64, device=dev), True)
    print(f"kernel far_list (Pallas prototype's units, NU {K3_UNITS}): max "
          f"|diff|/max|ref| a0 a1 a2 pot "
          + " ".join(f"{d:.2e}" for d in diffs)
          + f", kernel {ms:.3f} ms (units to lists included), plain "
          f"{plain_ms:.3f} ms, xla_ref in PyTorch {ref_ms:.3f} ms, bound "
          f"{bound_ms(*k3)[0]:.4f} ms [{card}]", flush=True)
    assert max(diffs) < 1e-5, diffs

    g = torch.Generator(device="cpu").manual_seed(SEED)
    tbl6 = torch.randn(K6_CAP, 16, generator=g).to(dev)
    ids6 = torch.randint(0, K6_CAP, (K6_BLOCKS, K6_IDS), generator=g,
                         dtype=torch.int32).to(dev)
    check_gather(res, "gather_rows", gather_rows, gather_rows_plain, tbl6,
                 ids6, f"probe ({K6_CAP}, 16) x {K6_BLOCKS} x {K6_IDS}",
                 card, gather_work, bound_ms)
    for logm in (14, 10):
        tbl45 = torch.randn(1 << logm, 16, generator=g).to(dev)
        ids45 = torch.randint(0, 1 << logm, (K45_IDS,), generator=g,
                              dtype=torch.int32).to(dev)
        check_gather(res, "gather_rowsum", gather_rowsum, gather_rowsum_plain,
                     tbl45, ids45, f"probe 8M ids from (2^{logm}, 16)", card,
                     gather_work, bound_ms)

    # ---- the first slice's path: the walk on every step ---------------------
    wsim = Simulation(flagship_config(ListMode=0), mode="phased", device=dev)
    wsim.set_particles_from_arrays(pos, vel, mass, np.ones(n, np.int32),
                                   pad_to_multiple=4096)
    zero_counts()
    wsim.prepare()
    wsim.compute_potential()
    e_start = sim_energy(wsim)
    wovf = 0
    t0 = time.perf_counter()
    for _ in range(WALK_STEPS):
        wsim.step()
        wovf += sum(int(wsim.last_walk_info[k]) for k in
                    ("ovf_open", "ovf_big", "ovf_items"))
        print(f"walk step ({'rebuild' if wsim.last_step_rebuilt else 'refresh'}"
              "): " + ", ".join(f"{ph} {s * 1e3:.1f} ms" for ph, s in
                               wsim.last_phase_wall.items()) + f" [{card}]")
    torch.cuda.synchronize()
    t_walk = time.perf_counter() - t0
    wsim.compute_potential()
    torch.cuda.synchronize()
    walk_launches = read_counts()
    wl = {k: walk_launches[k] for k in ("far_level", "near_level")}
    de = abs(sim_energy(wsim) - e_start) / abs(e_start)
    print(f"walk path (ListMode 0): N {n}, {WALK_STEPS} steps "
          f"{t_walk:.3f} s, {n * WALK_STEPS / t_walk:.1f} particle-steps/s, "
          f"|dE/E| {de:.3e}, launches {wl}, overflow {wovf} [{card}]",
          flush=True)
    assert wovf == 0 and de < 1e-3 and min(wl.values()) > 0, (wovf, de, wl)
    assert bool(torch.isfinite(wsim.particles.pos).all())

    replaces = {
        "far_level": ("sidm_tpu_torch/csrc/far_kernel.cu",
                      "sidm_tpu/ops/pallas_far.py:55"),
        "far_level_record": ("sidm_tpu_torch/csrc/far_kernel.cu",
                             "sidm_tpu/ops/pallas_far.py:55"),
        "near_level": ("sidm_tpu_torch/csrc/near_kernel.cu",
                       "sidm_tpu/ops/pallas_near.py:30"),
        "far_list": ("sidm_tpu_torch/csrc/far_list.cu",
                     "scripts/pallasfar.py:57"),
        "gather_rows": ("sidm_tpu_torch/csrc/gather.cu",
                        "scripts/pallas_gather_probe.py:40"),
        "gather_rowsum": ("sidm_tpu_torch/csrc/gather.cu",
                          "scripts/gatherbench.py:65,99"),
    }
    kernels_json = []
    for name, (src_file, repl) in replaces.items():
        r = res.rows[name]
        bms, by = bound_ms(r["ops"], r["bytes"])
        kernels_json.append({
            "name": name, "route": "cuda", "source": src_file,
            "replaces": repl, "launches": launches[name],
            "launches_by_path": {"lists": launches[name],
                                 "walk": walk_launches[name]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("full_ms", "full_bound_ms", "walk_ms",
                                 "walk_bound_ms") if k in r}})
    print(json.dumps({"kernels": kernels_json}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def check_gather(res, name, kern, plain, tbl, ids, label, card, gather_work,
                 bound_ms):
    """A gather kernel against its plain version (rows: bit-equal; row
    sums: 1e-5 of the largest), with times; for rows, one PyTorch call
    that computes the same function (index_select) as the yardstick."""
    rowsum = name == "gather_rowsum"
    out_k, out_p = kern(tbl, ids), plain(tbl, ids)
    max_abs = float(torch.max(torch.abs(out_k - out_p)))
    if rowsum:
        assert max_abs <= 1e-5 * float(torch.max(torch.abs(out_p))), max_abs
    else:
        assert torch.equal(out_k, out_p), name
    ms = cuda_ms(lambda: kern(tbl, ids), 10)
    plain_ms = cuda_ms(lambda: plain(tbl, ids), 3)
    lib_ms = None
    if not rowsum:
        ext = torch.cat([tbl, torch.zeros(1, 16, device=tbl.device)])
        flat = ids.reshape(-1).long()
        lib_ms = cuda_ms(lambda: torch.index_select(ext, 0, flat), 10)
    ops, nb = gather_work(tbl, ids, rowsum)
    print(f"kernel {name} ({label}): ids {ids.numel()}, "
          f"{'max abs ' + format(max_abs, '.3e') if rowsum else 'bit-equal'}"
          f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
          + ("" if lib_ms is None else f", index_select {lib_ms:.4f} ms")
          + f", bound {bound_ms(ops, nb)[0]:.4f} ms [{card}]", flush=True)
    res.add(name, max_abs, ms, plain_ms, ops, nb, lib_ms)


def check_split(name, kern, plain, card):
    """The kernel's work items (its split launches) equal the plain
    split's, field by field."""
    for k, v in plain.items():
        assert torch.equal(kern[k].cpu(), v.cpu()), (name, k)
    n_it = plain["item_g"].shape[0]
    unit = plain["unit"][plain["off"][1:] > plain["off"][:-1]]
    print(f"split {name}: {n_it} items for {plain['off'].shape[0] - 1} "
          f"groups (most in a group "
          f"{int(torch.max(plain['off'][1:] - plain['off'][:-1]))}, item "
          f"size {int(unit.min())} to {int(unit.max())}), equal to the plain "
          f"split [{card}]", flush=True)


def stress_groups(lists, k):
    """k groups of the lists with every target valid and a far list."""
    ok = torch.nonzero(lists.gvalid.all(dim=1) & (lists.nf > 0)).flatten()
    return ok[torch.linspace(0, len(ok) - 1, k, device=ok.device).long()]


def compare(kern, plain, kw, valid):
    """kern vs plain on kw, without and with the potential: ([p99.9 acc
    err, p99.9 acc err with pot, p99.9 pot err], max |diff| over the valid
    targets, the kernel's two outputs)."""
    errs, max_abs, outs = [], 0.0, []
    for pot in (False, True):
        out_k = kern(**kw, need_pot=pot)
        out_p = plain(**kw, need_pot=pot)
        e, ep = rel_err(out_k, out_p, valid)
        errs += [q999(e)] + ([q999(ep)] if pot else [])
        max_abs = max(max_abs,
                      float(torch.max(torch.abs(out_k - out_p)[valid])))
        outs.append(out_k)
    return errs, max_abs, outs


def check_stress(res, name, kern, plain, kw, valid, empty, label, card):
    """kern vs plain on a stress input, with and without the potential:
    p99.9 relative error < 2e-5, finite everywhere, the empty groups 0."""
    errs, max_abs, outs = compare(kern, plain, kw, valid)
    for out_k in outs:
        assert bool(torch.isfinite(out_k).all()), (name, label)
        assert bool(torch.all(out_k[empty] == 0)), (name, label)
    print(f"stress {name} ({label}): p99.9 acc err {errs[0]:.3e} (with pot "
          f"{errs[1]:.3e}, pot {errs[2]:.3e}), max abs {max_abs:.3e}, "
          f"finite, empty groups 0 [{card}]", flush=True)
    assert max(errs) < 2e-5, (name, errs)
    res.add(name, max_abs, 0.0, 0.0, 0.0, 0.0)


def far_stress(res, lists, ctbl, xc, te, gc, card):
    """far_list on four groups: two lists at far_cap (a real group's list
    repeated; the second with dead ids, -1 and the zero row, every few
    entries) beside two empty lists."""
    from sidm_tpu_torch.ops.far_list import far_list, far_list_plain

    LF = lists.far.shape[1]
    pick = stress_groups(lists, 4)
    ids = torch.full((4, LF), -1, dtype=torch.int32, device=ctbl.device)
    nf = torch.zeros(4, dtype=torch.int32, device=ctbl.device)
    for i in (0, 2):
        src = lists.far[pick[i], :int(lists.nf[pick[i]])]
        ids[i] = src.repeat(-(-LF // src.shape[0]))[:LF]
        nf[i] = LF
    ids[2, ::7] = -1
    ids[2, 3::11] = ctbl.shape[0] - 1
    kw = dict(tbl=ctbl, ids=ids, nf=nf, xc=xc[pick].contiguous(),
              te=te[pick].contiguous(), gc=gc[pick].contiguous())
    check_stress(res, "far_list", far_list, far_list_plain, kw,
                 lists.gvalid[pick], torch.tensor([1, 3]),
                 f"two lists at the cap {LF} beside two empty lists", card)


def near_stress(res, lists, btree, gt, te, card):
    """near_level on four groups: one at the near cap (K keys of cnt 31
    from random starts) beside two empty groups, and one whose keys cover
    its own targets (self pairs) and 31 particles moved onto its first
    target (coincident pairs)."""
    from sidm_tpu_torch.ops.near_kernel import near_level, near_level_plain

    dev = gt.device
    K = lists.near.shape[1]
    n = btree.pos_s.shape[0]
    pick = stress_groups(lists, 4)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    keys = torch.full((4, K), 2147483647, dtype=torch.int32, device=dev)
    n_seg = torch.zeros(4, dtype=torch.int32, device=dev)
    keys[0] = (torch.randint(0, n - 31, (K,), generator=g) * 32 + 31).to(
        dev, torch.int32)
    n_seg[0] = K
    pidx = lists.pidx[pick[2]].to(torch.int32)
    pc = (int(pidx[0]) + n // 2) % (n - 31)
    pos = btree.pos_s.clone()
    pos[pc:pc + 31] = gt[pick[2], 0]
    keys[2, :64] = pidx * 32 + 1
    keys[2, 64] = pc * 32 + 31
    n_seg[2] = 65
    kw = dict(keys=keys, n_seg=n_seg, pos_s=pos, mass_s=btree.mass_s,
              eps_s=btree.eps_s, xr=gt[pick].contiguous(),
              te=te[pick].contiguous())
    check_stress(res, "near_level", near_level, near_level_plain, kw,
                 lists.gvalid[pick], torch.tensor([1, 3]),
                 f"one group at the cap {K} x 31 beside two empty groups, "
                 "self and coincident pairs", card)


def sim_energy(sim) -> float:
    from sidm_tpu_torch.diagnostics import compute_system_state
    s = compute_system_state(sim.particles)
    return float(s.energy_kin + s.energy_pot)


if __name__ == "__main__":
    sys.exit(main())
