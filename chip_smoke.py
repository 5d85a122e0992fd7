"""Smoke test of the PyTorch port (sidm_tpu_torch) on one CUDA card.

Run from the root of a checkout on a machine with an H100:

    python3 chip_smoke.py            # N = 1e6 flagship halo

Phases (each asserts; any failure exits non-zero):
  1. card: name and power limit from nvidia-smi;
  2. build: compile the CUDA kernels from csrc/, one nvcc per source, all
     in parallel (timed);
  3. walk kernels vs plain on the N = 1e6 NFW tree: far_level against
     its plain version on every level of one walk and of one recording
     walk (skin 0), all groups: the compacted outputs (far ids, segment
     keys, next frontier, big-cell chunk keys), the counts, the lists and
     their telemetry bit-equal, the walk's info equal to what the plain
     outputs give; its time per walk and per record walk beside its bound
     and the former dense-plane contract's bound; the walk's far field
     (far_list on each level's compacted far ids) to p99.9 relative error
     < 2e-5 with and without the potential, timed per walk, and on the
     level that sets that p99.9 the kernel and the plain version each
     against the plain version in float64; the same checks with small caps
     (w_max, open_cap, big_cap, big_chunks, lvl_cap, far_cap, near_cap; the
     big-cell caps on a depth-10 tree of the same particles), each
     overflowing; near_level on a shallow, a deep and the last level
     and the big-cell chunks for a subset of groups against its plain
     version, with times of both, timed on every level of the walk for all
     groups (its time per walk, with its bound) and held against its plain
     version on all groups of the level with the most segments;
  4. oracles: the walk, and the cached lists recorded at skin 0 on the same
     fresh tree, at N = 1e6 (theta 0.5, geometric opening) against the
     direct sum on 4096 random targets (p99 <= 1e-3);
  5. main path: bench.py's configuration with SIDMOn 0, TreeWalkEngine wq,
     ListMode 1 through Simulation: prepare, 8 steps, compute_potential;
     >= 2 record steps (prepare's included), >= 4 list steps, no list or
     walk overflow, finite positions, |dE/E| < 1e-3, and launches of
     far_level (record), far_list, near_level and gather_nodes;
  6. list kernels vs plain: far_list and near_level on the main path's
     recorded lists, for 512 groups (timed against the plain versions) and
     for all groups (timed, with the bound), with and without the
     potential (p99.9 relative error < 2e-5, finite), their work items on
     all groups equal to the plain split; stress inputs at
     the same bars (far: two lists at far_cap, one with dead ids, beside
     empty lists; near: a group at the near cap of K keys of cnt 31 beside
     empty groups, self and coincident pairs); gather_nodes (the compact
     table from the tree's arrays) bit-equal to the packed table's rows in
     the columns it writes, timed against its plain version and against
     pack_tree + flat_tables + index_select; gather_rows bit-equal at the
     compact table's shape;
  7. the TPU probes' shapes: far_list through the Pallas far prototype's
     interface (NU = 2048 units) against its XLA reference (max |diff| /
     max |ref| < 1e-5), gather_rows bit-equal at (65536, 16) x 256 x 2048
     ids, gather_rowsum at 8M ids from (2^14, 16) and (2^10, 16);
  8. first slice's path: ListMode 0 (the walk every step) through
     Simulation: prepare, 2 steps, compute_potential, with far_level,
     far_list and near_level launched, no overflow, |dE/E| < 1e-3;
  9. flagship-dsmc (bench.py's SIDM settings on the lists,
     flagship_config(**DSMC)) through Simulation: prepare (the hsml init's
     11 counting passes and the first candidate record), compute_potential,
     8 steps, compute_potential: >= 2 candidate records (prepare's
     included), scatters > 0, no candidate segment drops, K drops only at
     the K ceiling (sidm_trunc_frac printed), no gated or tail drops, no
     force-list or walk overflow, finite state, |dE/E| < 1e-3, every
     step's kicks conserving momentum (|sum m dv| <= 1e-5 sum m |dv|), and
     launches of the range walk (range_segments, one launch a walk), the
     candidate emission and its count mode (sidm_emit), the gated tile
     (sidm_gated), far_level (record), far_list, near_level and
     gather_nodes; then, on the run's end state, the range walk of a
     record and of a prepare pass in one launch against the plain walk
     (range_walk_plain, level by level), all groups: keys with their IMAX
     tails, counts, ovf, need, telemetry and drops bit-equal, one
     far_level.range_launches a walk, the live frontier widths per level
     printed, timed per walk (the walk kernel's and the call's device
     time, the call by CUDA events, beside the parent design's times and
     the bound); the same equality for the record's walk with the caps cut
     small (open_cap, big_cap, big_chunks, seg_cap and lvl_cap in one walk,
     the frontier width w_max in another: each path drops) and with every
     frontier id through the global scratch row (shared_ids 0); the
     groups' staged-particle totals (segment_totals,
     the emission's longest-first order and the segment pass's weights)
     bit-equal on a record's and a prepare pass's lists; the emission and its count mode bit-equal to
     the plain version (every row) on a subset of groups with the 8
     longest among them, at the run's K and at K = 16 (truncating), timed
     on all groups beside the parent design's time, the bound (of the
     pairs in the batches each target may reach) and ptxas's registers;
     the gated tile on the next step's targets: counts equal, P_tot p99.9
     relative error < 1e-5, partners equal except at near-ties (counted),
     timed as one call (its fill included) with its device time split
     between the fill and the tile, beside the parent design's;
 10. flagship-dsmc-walk (bench.py's SIDM settings on the walk,
     flagship_config(**DSMC_WALK)) through Simulation: prepare,
     compute_potential, 4 steps, compute_potential: scatters > 0, no walk
     or segment drop of the DSMC range walk, no force walk overflow,
     |dE/E| < 1e-3, every step's kicks conserving momentum, launches of
     the range walk and the segment pass (sidm_near, K4) beside the force
     walk's kernels; on its end state the next step's range walk against
     the plain walk (as in phase 9, timed), and K4
     against sidm_near_plain on a subset of the next step's gated groups
     with the 8 longest among them and two groups made from the longest,
     one with a single live slot and one with all 64 live (counts equal,
     P_tot p99.9 < 1e-5, partners equal except at near-ties), timed on all
     groups with its bound, the parent design's time, the staged particles
     and live slots per group, its work items, and ptxas's registers. Then a periodic
     uniform box at N = 1e5 (the rate harness's): the range walk (one
     launch, all groups, timed) and the emission (and its count mode)
     bit-equal to their plain versions with the box, the gated tile and
     K4 at phase 9's bars, one pass of each DSMC engine on the same inputs
     (equal neighbour counts, partners equal except at near-ties), and a
     short rate check (hard sphere, 64 passes, both engines, held to the
     harness's bar max(1 %, 3 sigma) with no drop);
 11. the run loop and the CLI: bench.py's run (``bench.bench_config()``,
     SIDM on the cached lists at cadence 16) with ``ScatterLog 1`` from a
     Gadget IC of the same halo written by the port's writer, through the
     calls ``cli.main`` makes (``from_parameter_file``, ``load_ic``,
     ``prepare``, ``run(max_steps=6)``), the statistics and snapshot
     cadences set from phase 9's step times so that the window holds two
     statistics and one snapshot: the snapshot read back by the native and
     the numpy readers bit-equal to the predicted state at its write, two
     energy rows of 24 finite columns with |dE/E| < 1e-3, the info, CPU and
     timings logs one entry per step, the scatter log's records as many as
     the steps' scatters with valid ids, the restart file bit-equal to the
     state written, and launches of far_level (walk and record modes), the
     range walk, near_level, far_list, gather_nodes, sidm_emit (and its
     count mode) and sidm_gated; then ``python -m sidm_tpu_torch <param>
     1`` with a ``stop`` file: exit 0 after one step, its restart at step
     7, its logs appended, the next snapshot and ``sct_`` numbers taken;
     it prints particle-steps/s over the 6 steps and the walls of the IC
     write, prepare, energy_statistics, the snapshot, the restart write and
     the resumed process;
 12. the single-program step: small-halo (``flagship.small_config()``,
     bench.py's halo and SIDM settings at N = 261888, ``mode=
     "synchronized"``) through Simulation: prepare (the hash grid's
     smoothing-length init, its cap grown to the demand), compute_potential,
     4 steps, compute_potential: scatters > 0, no bucket read past the
     grown cap and no clipped level, no walk overflow (the step redoes an
     overflowing depth-10 walk at depth 13), |dE/E| < 1e-3, every step's
     kicks conserving momentum, and launches of hash_knn (H1), hash_scan
     (H2), far_level, far_list and near_level; then, on its end state, H1
     on all N queries bit-equal to its plain version (h, counts, overflow,
     need, clip, rows read), H2 on the next step's gated targets (partners
     equal except near-ties, counted), H3 on 4096 random targets (p99.9
     relative error < 1e-5 on acc and pot), each timed beside its bound and
     ptxas's registers; the same run with ForceMethod direct (prepare, 2
     steps, the same asserts, launches of H3); the hash engine's 64-pass
     rate check on phase 10's box from setup_smoothing_lengths (printed,
     not held to the bar);
 13. individual timesteps and the velocity-dispersion pass:
     flagship-veldisp (``flagship_config(**VELDISP)``: the lists with
     ``VelDispOn 1`` and timestep criterion 4) synchronized through
     Simulation: prepare (its first pass from no smoothing length timed,
     with its rows read a query), compute_potential, 4 steps,
     compute_potential: no list or walk overflow, no bucket past the grown
     cap and no clipped level in any pass, |dE/E| < 1e-3, and launches of
     hash_knn (H1), veldisp (H4), near_level, far_list, far_level (both
     modes) and gather_nodes; on its end state the next step's pass against
     its plain version on 65536 random queries and the 8 that read the
     most rows (hsml_vd and counts equal, dens_vd and vel_disp p99.9
     relative error < 1e-5), H4 on all queries timed beside its bound and
     its plain version; then ``mode="individual"``: flagship-veldisp (6
     steps), flagship-dsmc and small-halo (4 steps each) after prepare,
     each step's active particles printed (fewer than N), the inactive
     particles' pos, vel, times and veldisp fields unchanged bit for bit,
     the DSMC kicks conserving momentum with no drop, steps that gate no
     target among them, |dE/E| < 1e-3 at the common predicted time;
 14. periodic boxes, TreePM and comoving runs: cosmo-box
     (``flagship.cosmo_config()``: the clustered periodic box of
     scripts/profile_treepm.py at N = 2^20, mesh 256, comoving from
     a = 0.1) through Simulation on the phased step: prepare and 5 steps
     (refreshes and a rebuild), each step's phase walls and a, a advancing,
     positions in [0, box), no walk overflow, and launches of the periodic
     modes of far_level, far_list and near_level; the mesh solve timed by
     part (deposits, FFTs, gathers); TreePM (walk + mesh, the run's
     opening, geometric theta 0.5; the run's relative criterion printed
     beside it) against H3's periodic Ewald direct sum on 4096 random
     targets at that test's bars (acc p99 < 2.5e-3, max < 6e-3, pot p99 <
     8e-3, each against max(|a|, median |a|), potential energy within
     5e-3); every periodic
     kernel call of one walk of the end state against its plain version
     (far_level's lists equal as sets and its counts equal; far_list and
     near_level p99.9 < 2e-5 on acc and pot), timed per walk beside its
     bound and plain time; H3 periodic against the plain periodic direct
     sum on 1024 targets (p99.9 < 1e-5 on acc and pot against max(|plain|,
     median |plain|)), timed on 4096;
     a periodic box of 4096 particles with ForceMethod direct on the
     single-program step (4 steps, |dE| < 0.2 E_kin); JAX's comoving
     lattice at 64^3 particles on the phased step, static to < 2e-3 box.
Before the last line it prints one JSON object with the per-kernel results
(``launches``: the sum over the main paths driven here, ``launches_by_path``:
phase 5's ("lists"), phase 8's ("walk"), phase 9's ("dsmc"), phase 10's
("dsmc_walk"), phase 11's ("cli"), phase 12's ("small", "small_direct"),
phase 13's ("veldisp", "veldisp_individual", "dsmc_individual",
"small_individual") and phase 14's ("cosmo", "periodic_direct",
"lattice") counts, each path's counters set to 0 just before it and read
just after; the periodic modes as rows of their own,
``far_level_periodic``, ``far_list_periodic``, ``near_level_periodic``
and ``direct_periodic``, with the JAX function each ports in ``ports``
and the cosmo-box mesh solve's parts in ``cosmo_pm``; for far_list and
near_level ``full_ms`` and ``full_bound_ms`` on all groups of the lists, for near_level and far_list
``walk_ms`` and ``walk_bound_ms`` per walk, far_list's float64
``witness``, for far_level (walk and record modes) ``ms`` per walk on all
groups with ``dense_bound_ms``) and the card's name and power limit; the
last line is {"ok": true, "device": {...}}.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 12345
STEPS = 8              # list path and DSMC path, after prepare
WALK_STEPS = 2         # first slice's path, after prepare
ORACLE_TARGETS = 4096  # random targets held against the direct sum
SUBSET_GROUPS = 512    # groups per call in the kernel-vs-plain checks
K3_UNITS = 2048        # scripts/pallasfar.py NU
K6_CAP, K6_BLOCKS, K6_IDS = 65536, 256, 2048   # pallas_gather_probe.py
K45_IDS = 1 << 23      # scripts/gatherbench.py F
EMIT_GROUPS = 64       # groups of the emission's kernel-vs-plain check
EMIT_TINY_K = 16       # the truncating K of that check
WALK_DSMC_STEPS = 4    # flagship-dsmc-walk, after prepare
BOX_N = 100_000        # the periodic box of phase 10 (the rate harness's)
RATE_PASSES = 64       # phase 10's short rate check, per engine
LONGEST = 8            # the longest groups added to each DSMC kernel's
                       # kernel-vs-plain subset
# the DSMC kernels' parent designs (sidm_emit.cu: one thread per target,
# 64 a block; sidm_near.cu: 4 threads per slot, all 64 slots) at these
# shapes: this script's run on the tree before their redesign (NVIDIA
# H100 80GB HBM3, 700 W), printed beside the kernel lines' own times (not
# in the kernels JSON line, which holds only this run's measurements)
PARENT_MS = {"sidm_emit": 4.834, "sidm_emit_count": 4.995,
             "sidm_near": 9.9736, "sidm_emit_box": 0.997,
             "sidm_near_box": 0.1875}
# the range walk's and the gated tile's parent designs (far_level's range
# mode, one launch a level; the tile after four (n,) fills, a warp a target
# slot) as this script printed them on the tree before their redesign, in
# PR 8's run (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), printed
# beside the kernel lines' own times (not in the kernels JSON line). Range
# walk: (device ms of its far_level launches, their calls' ms, None where
# that run's line is not kept); gated tile: ms of one call, fills included.
# That script did not time the DSMC walk's range walk.
PARENT_RANGE = {"record": (0.506, 1.281), "prepare pass": (0.492, None),
                "rate box": (0.061, None)}
PARENT_GATED = {"dsmc": 0.109, "rate box": 0.0790}
USAGE = {}             # kernel -> ptxas's registers, shared memory, spills


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_usage(log: str) -> dict:
    """{entry function: "R registers, S B smem, spills ..."} from nvcc's
    -Xptxas -v output."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "spill stores" in line:
            out[entry] = line.strip()
        elif entry and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].strip()
            out[entry] = f"{regs}; {out.get(entry, '')}"
            entry = None
    return out


def usage_of(kernel: str) -> str:
    """ptxas's lines of the entry functions named ``kernel`` (one per
    template instance), "not built here" when the libraries were reused."""
    found = [v for k, v in USAGE.items() if kernel in k]
    return " | ".join(found) if found else "not built here"


def pair_counts(cnt: dict) -> str:
    """The emission bound's pair counts (bounds.emit_work's ``counts``)."""
    return (f"{cnt['reach_pairs']} of {cnt['pairs']} (target, staged "
            f"particle) pairs in reachable batches, {cnt['box_tests']} box "
            f"tests")


def with_longest(sub, tot, k=LONGEST):
    """The groups ``sub`` and the ``k`` with the most staged particles."""
    top = torch.topk(tot, min(k, tot.numel())).indices
    return torch.unique(torch.cat([sub, top]))


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


def loaded_ms(fn, reps: int):
    """Device ms per call over ``reps`` calls of fn, by CUDA events around
    the calls while the device is held busy (``torch.cuda._sleep``) until
    the host has queued them all, so that no host time falls between the
    events. None if the device was no longer busy by then (fn waits for the
    device)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # ~2e6 clock cycles a millisecond: twice the calls' host time and 5 ms
    torch.cuda._sleep(int(2e6 * (2 * reps * host_ms + 5)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    queued = not a.query()
    b.synchronize()
    return a.elapsed_time(b) / reps if queued else None


def device_time(fn, reps: int, names, whole: bool):
    """Device ms per call of the kernels named ``names``
    (``profile_step.device_ms``), profiled again (three tries) when
    torch.profiler saw no device event of them (it sometimes reports none).
    If it never does: where those kernels are all the call's device work
    (``whole``), the call's device time by ``loaded_ms``, else None; a
    phase fails if neither can time it. Returns (ms or None, how)."""
    from sidm_tpu_torch.profile_step import device_ms
    for _ in range(3):
        ms = device_ms(fn, reps, names)
        if ms > 0:
            return ms, "torch.profiler"
    ms = loaded_ms(fn, reps) if whole else None
    how = ("CUDA events on a loaded device (torch.profiler saw no device "
           "event)" if ms is not None else
           "not measured (torch.profiler saw no device event)")
    print(f"  ({names}: {how})", flush=True)
    assert ms is not None or not whole, (names, how)
    return ms, how


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
        self.notes = {}     # name -> the device times not by torch.profiler

    def note(self, name, label, how):
        self.notes.setdefault(name, []).append(f"{label}: {how}")

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


def prefix_equal(a, b, n, tail) -> bool:
    """Rows of a and b equal in their first n[g] entries (the entries past
    a count are not part of an output)."""
    live = torch.arange(a.shape[1], device=a.device)[None, :] < n[:, None]
    return a.shape == b.shape and torch.equal(torch.where(live, a, tail),
                                              torch.where(live, b, tail))


class FarLevelCheck:
    """far_level against far_level_plain on every level of a walk and of a
    recording walk (``walk_level`` and ``record_level``, ``on_level``
    observers of wq_gravity_tree and record_lists), all groups: compacted
    outputs, counts, lists and telemetry bit-equal; the walk's info
    recomputed from the plain outputs (``check_info``). The walk's far
    field, far_list on each level's compacted far ids, against
    far_list_plain to p99.9 < 2e-5 with and without the potential, and on
    the level that sets that p99.9 against the plain version in float64
    (``witness``). Unless ``stress``, each level is also timed (kernel,
    call, plain) and its bounds summed (for far_level also the
    dense-plane contract's bound)."""

    FIELDS = (("far", 0, 2147483647), ("seg", 1, 2147483647),
              ("fids", 2, -1), ("bkey", 6, 2147483647))

    def __init__(self, card, stress=False):
        self.card, self.stress = card, stress
        self.t = {m: dict(levels=0) for m in ("walk", "record", "far_list")}
        self.err, self.max_abs = 0.0, 0.0   # the walk's far field vs plain
        self.worst = None                   # (level, which, its far_list kw)
        self.far_total = 0.0                # the plain far field, all levels
        self.info = dict(n_segs=0, ovf_open=0, ovf_big=0, max_open=[])

    def _same(self, k, p):
        assert torch.equal(k.cnt, p.cnt), "far_level counts"
        for f, row, tail in self.FIELDS:
            if getattr(p, f) is not None:
                assert prefix_equal(getattr(k, f), getattr(p, f), p.cnt[row],
                                    tail), ("far_level", f)

    def _time(self, mode, level, width, ms, call_ms, plain_ms, work,
              dense=(0.0, 0.0)):
        from sidm_tpu_torch.bounds import bound_ms
        t = self.t[mode]
        t["levels"] += 1
        for key, v in (("ms", ms), ("call_ms", call_ms),
                       ("plain_ms", plain_ms), ("ops", work[0]),
                       ("bytes", work[1]), ("dense_ops", dense[0]),
                       ("dense_bytes", dense[1])):
            t[key] = t.get(key, 0.0) + v
        name = {"walk": "far_level (walk)", "record": "far_level (record)",
                "far_list": "far_list (walk far field)"}[mode]
        print(f"  {name} level {level}: width {width}, device {ms:.3f} ms, "
              f"call {call_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms(*work)[0]:.4f} ms"
              + (f", dense-plane bound {bound_ms(*dense)[0]:.4f} ms"
                 if dense[1] else ""), flush=True)

    def walk_level(self, name, level, kw):
        if name == "far_level":
            self._classify(level, kw)
        elif name == "far_list":
            self._far_field(level, kw)

    def _classify(self, level, kw):
        from sidm_tpu_torch.bounds import far_level_dense_work, far_level_work
        from sidm_tpu_torch.ops.far_kernel import (C_BIG, C_BIG_DROP, C_BK,
                                                   C_OPEN, C_OVF_OPEN, C_SEG,
                                                   far_level, far_level_plain)
        from sidm_tpu_torch.profile_step import FAR_LEVEL_KERNELS, device_ms
        k, p = far_level(**kw), far_level_plain(**kw)
        self._same(k, p)
        c = p.cnt.long()
        self.info["n_segs"] += int(c[C_SEG].sum() + c[C_BK].sum())
        if kw["last"]:
            self.info["ovf_big"] += int(
                torch.clamp(c[C_BIG] - kw["big_cap"], min=0).sum()
                + c[C_BIG_DROP].sum())
        else:
            self.info["ovf_open"] += int(c[C_OVF_OPEN].sum())
            self.info["max_open"].append(int(c[C_OPEN].max()))
        if self.stress:
            return
        self._time("walk", level, kw["fids"].shape[1],
                   device_ms(lambda: far_level(**kw), 5, FAR_LEVEL_KERNELS),
                   cuda_ms(lambda: far_level(**kw), 5),
                   cuda_ms(lambda: far_level_plain(**kw), 1),
                   far_level_work(kw, p.cnt), far_level_dense_work(kw))

    def _far_field(self, level, kw):
        from sidm_tpu_torch.bounds import far_list_work
        from sidm_tpu_torch.ops.far_list import far_list, far_list_plain
        from sidm_tpu_torch.profile_step import FAR_LIST_KERNELS, device_ms
        valid = kw["te"] != 1.0
        errs = {}
        for pot in (False, True):
            pkw = dict(kw, need_pot=pot)
            a, b = far_list(**pkw), far_list_plain(**pkw)
            assert bool(torch.isfinite(a).all())
            e, ep = rel_err(a, b, valid)
            errs["acc with pot" if pot else "acc"] = q999(e)
            if pot:
                errs["pot"] = q999(ep)
                if not self.stress:
                    self.far_total = self.far_total + b[..., :3]
            self.max_abs = max(self.max_abs,
                               float(torch.max(torch.abs(a - b)[valid])))
        assert max(errs.values()) < 2e-5, ("walk far field", level, errs)
        which = max(errs, key=errs.get)
        if self.worst is None or errs[which] > self.err:
            self.err = errs[which]
            self.worst = (level, which, kw)
        if self.stress:
            return
        self._time("far_list", level, kw["ids"].shape[1],
                   device_ms(lambda: far_list(**kw), 5, FAR_LIST_KERNELS),
                   cuda_ms(lambda: far_list(**kw), 5),
                   cuda_ms(lambda: far_list_plain(**kw), 1),
                   far_list_work(kw["tbl"], kw["nf"], torch.sum(valid, 1),
                                 kw["need_pot"]))

    def witness(self):
        """The level that set the walk far field's p99.9: kernel and plain
        version (float32) each against the plain version in float64 on the
        same inputs, over all valid targets and over the targets at or
        above that p99.9 (the ones that set it); for those, the level's far
        field and the kernel's error against the float64 one relative to
        the target's whole far field (all levels)."""
        from sidm_tpu_torch.ops.far_list import far_list, far_list_plain
        level, which, kw = self.worst
        kw = dict(kw, need_pot=True)
        valid = kw["te"] != 1.0
        k, p = far_list(**kw), far_list_plain(**kw)
        d = far_list_plain(**{n: (v.double() if torch.is_tensor(v)
                                  and v.is_floating_point() else v)
                              for n, v in kw.items()})
        i = 1 if which == "pot" else 0
        e_kp = rel_err(k, p, valid)[i]
        e_kd = rel_err(k.double(), d, valid)[i]
        e_pd = rel_err(p.double(), d, valid)[i]
        top = e_kp >= torch.quantile(e_kp.float(), 0.999)
        gi, si = torch.nonzero(valid, as_tuple=True)
        w = int(torch.argmax(e_kp))
        nf = kw["nf"][gi[top]].float()
        tot = torch.linalg.norm(self.far_total[valid], dim=-1)
        lvl = torch.linalg.norm(d[..., :3][valid], dim=-1)
        k_err = torch.linalg.norm((k.double() - d)[..., :3][valid], dim=-1)
        out = dict(level=level, error=which, targets=int(valid.sum()),
                   top=int(top.sum()),
                   top_groups=int(gi[top].unique().numel()),
                   kernel_vs_plain=q999(e_kp), kernel_vs_f64=q999(e_kd),
                   plain_vs_f64=q999(e_pd),
                   top_kernel_vs_f64=float(e_kd[top].median()),
                   top_plain_vs_f64=float(e_pd[top].median()),
                   worst=(int(gi[w]), int(si[w]), float(e_kp[w]),
                          float(e_kd[w]), float(e_pd[w])),
                   top_far_entries=(float(nf.min()), float(nf.median()),
                                    float(nf.max())),
                   top_level_over_far=float((lvl / tot)[top].median()),
                   top_kernel_err_over_far=float(
                       (k_err / tot)[top].median()),
                   kernel_err_over_far=q999(k_err / tot))
        print(f"float64 witness of the walk far field (level {level}, "
              f"{which} error, {out['targets']} valid targets): p99.9 kernel "
              f"vs plain {out['kernel_vs_plain']:.3e}, kernel vs float64 "
              f"{out['kernel_vs_f64']:.3e}, plain (float32) vs float64 "
              f"{out['plain_vs_f64']:.3e}; the {out['top']} targets at or "
              f"above the p99.9 (in {out['top_groups']} groups, far entries "
              f"min/median/max {out['top_far_entries']}): median error "
              f"kernel vs float64 {out['top_kernel_vs_f64']:.3e}, plain vs "
              f"float64 {out['top_plain_vs_f64']:.3e}, |level far field| / "
              f"|whole far field| {out['top_level_over_far']:.3e}, kernel's "
              f"error / |whole far field| {out['top_kernel_err_over_far']:.3e}"
              f" (p99.9 over all targets {out['kernel_err_over_far']:.3e}); "
              f"worst (group, slot, kernel vs plain, kernel vs f64, plain vs "
              f"f64) {out['worst']} [{self.card}]", flush=True)
        return out

    def check_info(self, info):
        """The walk's info equals what the plain outputs give."""
        got = dict(n_segs=int(info["n_segs"]),
                   ovf_open=int(info["ovf_open"]),
                   ovf_big=int(info["ovf_big"]),
                   max_open=[int(x) for x in info["max_open"]])
        assert got == self.info, (got, self.info)

    def record_level(self, level, kw):
        from sidm_tpu_torch.bounds import far_level_dense_work, far_level_work
        from sidm_tpu_torch.ops.far_kernel import (ListBuf, far_level,
                                                   far_level_plain)
        from sidm_tpu_torch.profile_step import FAR_LEVEL_KERNELS, device_ms
        bufs = [ListBuf(*(t.clone() for t in kw["lists"])) for _ in range(2)]
        k = far_level(**dict(kw, lists=bufs[0]))
        p = far_level_plain(**dict(kw, lists=bufs[1]))
        assert all(torch.equal(a, b) for a, b in zip(*bufs)), \
            ("far_level", "record", level)
        self._same(k, p)
        if self.stress:
            return
        # each timed launch appends the same entries again: the list counts
        # and telemetry are put back first (that copy timed alone, taken off)
        nf, nn, st = (t.clone() for t in kw["lists"][2:])

        def restore(b):
            b.nf.copy_(nf)
            b.nn.copy_(nn)
            b.stat.copy_(st)

        def timed(fn, b, reps):
            return (cuda_ms(lambda: (restore(b), fn(**dict(kw, lists=b))),
                            reps) - cuda_ms(lambda: restore(b), reps))
        self._time("record", level, kw["fids"].shape[1],
                   device_ms(lambda: (restore(bufs[0]),
                                      far_level(**dict(kw, lists=bufs[0]))),
                             5, FAR_LEVEL_KERNELS),
                   timed(far_level, bufs[0], 5),
                   timed(far_level_plain, bufs[1], 1),
                   far_level_work(kw, p.cnt), far_level_dense_work(kw))

    def report(self, mode, res):
        from sidm_tpu_torch.bounds import bound_ms
        t = self.t[mode]
        bms, by = bound_ms(t["ops"], t["bytes"])
        walk = {"record": "record walk"}.get(mode, "walk")
        name = {"walk": "far_level", "record": "far_level_record",
                "far_list": "far_list"}[mode]
        what = {"walk": "outputs, counts and info equal to the plain "
                        "version's",
                "record": "outputs, counts, lists and telemetry equal to "
                          "the plain version's",
                "far_list": f"the walk's far field, p99.9 err "
                            f"{self.err:.3e} (largest of acc, acc with pot, "
                            f"pot), max abs {self.max_abs:.3e}"}[mode]
        dense = (f"; dense-plane bound "
                 f"{bound_ms(t['dense_ops'], t['dense_bytes'])[0]:.3f} ms"
                 if t["dense_bytes"] else "")
        print(f"kernel {name} (one {walk}, all groups, {t['levels']} "
              f"levels): {what}; device {t['ms']:.3f} ms per {walk}, calls "
              f"{t['call_ms']:.3f} ms by CUDA events (host launch time "
              f"included), plain {t['plain_ms']:.3f} ms, bound {bms:.3f} ms "
              f"({by}), at {bms / t['ms']:.1%} of the bound's speed{dense} "
              f"[{self.card}]", flush=True)
        if mode == "far_list":
            res.add(name, self.max_abs, 0.0, 0.0, 0.0, 0.0)
            res.rows[name].update(walk_ms=t["ms"], walk_bound_ms=bms,
                                  walk_call_ms=t["call_ms"],
                                  walk_plain_ms=t["plain_ms"],
                                  walk_p999_err=self.err)
            return
        res.add(name, 0.0, t["ms"], t["plain_ms"], t["ops"], t["bytes"])
        res.rows[name].update(call_ms=t["call_ms"])
        if t["dense_bytes"]:
            res.rows[name].update(dense_bound_ms=bound_ms(
                t["dense_ops"], t["dense_bytes"])[0])


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
    from sidm_tpu_torch.bounds import (bound_ms, far_list_work,
                                       gather_nodes_work, gather_work,
                                       near_level_work)
    from sidm_tpu_torch.flagship import flagship_config, flagship_ics
    from sidm_tpu_torch.ops.direct import direct_gravity, direct_sum
    from sidm_tpu_torch.ops.neighbors import knn_radius
    from sidm_tpu_torch.ops.sidm import hash_scan
    from sidm_tpu_torch.ops.veldisp import veldisp_sums
    from sidm_tpu_torch.ops.far_kernel import far_level
    from sidm_tpu_torch.ops.far_list import (far_list, far_list_plain,
                                             far_split, far_units,
                                             k3_reference, units_to_lists)
    from sidm_tpu_torch.ops.work_items import (far_split_plain,
                                               near_split_plain)
    from sidm_tpu_torch.ops.fused_force import (FusedConfig, default_depth,
                                                flat_tables, pack_tree)
    from sidm_tpu_torch.ops.gather import (NODE_COLS, UNSET_COLS,
                                           gather_nodes,
                                           gather_nodes_plain, gather_rows,
                                           gather_rows_plain, gather_rowsum,
                                           gather_rowsum_plain)
    from sidm_tpu_torch.ops.list_force import (ListConfig, eval_inputs,
                                               eval_lists, record_lists)
    from sidm_tpu_torch.ops.fused_range import segment_totals, sidm_near
    from sidm_tpu_torch.ops.list_range import sidm_emit, sidm_gated
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
    USAGE.update(ptxas_usage(info["log"]))

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
    levels = {3, (3 + depth) // 2 + 1, depth, depth + 1}
    captured = {}
    sub = None
    walk_near = dict(calls=0, groups=0, ms=0.0, ops=0.0, bytes=0.0)
    fl = FarLevelCheck(card)

    def capture(name, level, kw):
        nonlocal sub
        if name != "near_level":     # far_level, far_list: all groups
            fl.walk_level(name, level, kw)
            return
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
        ng = kw["xr"].shape[0]
        if sub is None:
            sub = torch.linspace(0, ng - 1, min(SUBSET_GROUPS, ng),
                                 device=dev).long()
        captured[level] = {
            k: (v[sub].contiguous() if isinstance(v, torch.Tensor)
                and v.dim() > 0 and v.shape[0] == ng else v)
            for k, v in kw.items()}

    acc_w, _, winfo = wq_gravity_tree(
        tree, mass_t, eps_t, old0, theta=0.5, opening=1, need_pot=True,
        return_info=True, on_level=capture)
    torch.cuda.synchronize()
    fl.check_info(winfo)
    fl.report("walk", res)
    fl.report("far_list", res)
    res.rows["far_list"].update(witness=fl.witness())
    # the recording walk of the same tree (geometric opening, skin 0)
    record_lists(tree, old0[tree.perm], p.valid[tree.perm], theta=0.5,
                 use_relative=False, lcfg=sim._lfc, skin=0.0,
                 on_level=fl.record_level)
    torch.cuda.synchronize()
    fl.report("record", res)
    # the caps overflowing: the same checks with small caps, on this tree
    # (the opened-cell and frontier caps) and on a depth-10 tree of the
    # same particles, whose deepest cells hold more than 16 particles (the
    # big-cell caps, the level and list caps)
    tree10 = build_octree(p.pos, mass_t, eps_t, p.valid, depth=10,
                          uniform_eps=sim._check_uniform_eps())
    fs = FarLevelCheck(card, stress=True)
    sovf = {}
    for label, t, cfg in (
            ("w_max 256, open_cap 40", tree,
             FusedConfig(w_max=256, open_cap=40)),
            ("depth 10, big_cap 1 x 1 chunk", tree10,
             FusedConfig(big_cap=1, big_chunks=1))):
        fs.info = dict(n_segs=0, ovf_open=0, ovf_big=0, max_open=[])
        _, _, sinfo = wq_gravity_tree(
            t, mass_t, eps_t, old0, theta=0.5, opening=1, need_pot=False,
            config=cfg, return_info=True,
            on_level=lambda name, level, kw: (
                fs.walk_level(name, level, kw) if name != "near_level"
                else None))
        fs.check_info(sinfo)
        sovf[label] = (int(sinfo["ovf_open"]), int(sinfo["ovf_big"]))
    slists = record_lists(tree10, old0[tree10.perm], p.valid[tree10.perm],
                          theta=0.5, use_relative=False,
                          cfg=FusedConfig(big_cap=1, big_chunks=1),
                          lcfg=ListConfig(far_cap=256, near_cap=128,
                                          lvl_cap=48),
                          skin=0.0, on_level=fs.record_level)
    torch.cuda.synchronize()
    rovf = slists.ovf.tolist()
    print(f"stress far_level (all groups, every level; outputs, counts and "
          f"telemetry equal to the plain version's): walk (ovf_open, "
          f"ovf_big) {sovf}; record on the depth-10 tree with big_cap 1 x 1 "
          f"chunk, far_cap 256, near_cap 128, lvl_cap 48: ovf {rovf}; p99.9 "
          f"acc err {fs.err:.3e} [{card}]", flush=True)
    (o_open, _), (_, o_big) = sovf.values()
    assert o_open > 0 and o_big > 0 and min(rovf[:3]) > 0, (sovf, rovf)
    res.add("far_list", fs.max_abs, 0.0, 0.0, 0.0, 0.0)
    del slists, fs, tree10

    wbound, wby = bound_ms(walk_near["ops"], walk_near["bytes"])
    walk_near["bound_ms"] = wbound
    print(f"kernel near_level (one walk, all {walk_near['groups']} groups, "
          f"{walk_near['calls']} calls): kernel {walk_near['ms']:.3f} ms per "
          f"walk, bound {wbound:.3f} ms ({wby}), at "
          f"{wbound / walk_near['ms']:.1%} of the bound's speed [{card}]",
          flush=True)
    for level, kw in sorted(captured.items()):
        valid = kw["te"] != 1.0   # dead target slots carry te = 1
        nvalid = torch.sum(valid, dim=1)
        out_k = near_level(**kw)
        torch.cuda.synchronize()
        out_p = near_level_plain(**kw)
        torch.cuda.synchronize()
        e, ep = rel_err(out_k, out_p, valid)
        ops, nb = near_level_work(kw, nvalid)
        max_abs = float(torch.max(torch.abs(out_k - out_p)[valid]))
        ms = cuda_ms(lambda: near_level(**kw), 10)
        plain_ms = cuda_ms(lambda: near_level_plain(**kw), 2)
        print(f"kernel near_level level {level}: groups {out_k.shape[0]}, "
              f"p99.9 acc err {q999(e):.3e}, p99.9 pot err {q999(ep):.3e}, "
              f"max abs {max_abs:.3e}, kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms(ops, nb)[0]:.3f} ms "
              f"[{card}]", flush=True)
        assert q999(e) < 2e-5 and q999(ep) < 2e-5, ("near_level", level)
        res.add("near_level", max_abs, ms, plain_ms, ops, nb)
    assert len(captured) == 4, sorted(captured)
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
                "range_walk": (far_level, "range_launches"),
                "sidm_emit": (sidm_emit, "launches"),
                "sidm_emit_count": (sidm_emit, "count_launches"),
                "sidm_gated": (sidm_gated, "launches"),
                "sidm_near": (sidm_near, "launches"),
                "segment_totals": (segment_totals, "launches"),
                "near_level": (near_level, "launches"),
                "far_list": (far_list, "launches"),
                "gather_rows": (gather_rows, "launches"),
                "gather_rowsum": (gather_rowsum, "launches"),
                "gather_nodes": (gather_nodes, "launches"),
                "hash_knn": (knn_radius, "launches"),
                "hash_scan": (hash_scan, "launches"),
                "direct": (direct_sum, "launches"),
                "veldisp": (veldisp_sums, "launches"),
                "far_level_periodic": (far_level, "periodic_launches"),
                "far_list_periodic": (far_list, "periodic_launches"),
                "near_level_periodic": (near_level, "periodic_launches"),
                "direct_periodic": (direct_sum, "periodic_launches")}

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
    list_launches = read_counts()
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
          f"{list_launches}, overflow {ovf}, finite {finite}, diag far "
          f"{sim._diag_far} near {sim._diag_near} [{card}]", flush=True)
    assert finite and ovf == 0 and de < 1e-3, (finite, ovf, de)
    assert kinds.count("record") >= 2 and kinds.count("list") >= 4, kinds
    for key in ("far_level_record", "far_list", "near_level",
                "gather_nodes"):
        assert list_launches[key] > 0, (key, list_launches)

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

    # the compact table: gather_nodes from the tree's arrays against its
    # plain version (every column bit-equal, UNSET_COLS NaN) and against the
    # packed table's rows (NODE_COLS, bit-equal); gather_rows, the probe's
    # kernel, on the packed table itself
    src = torch.cat([lists.src, torch.full((1,), btree.mac_rows.shape[0],
                                           dtype=torch.int32, device=dev)])
    out_k = gather_nodes(btree, src)
    out_p = gather_nodes_plain(btree, src)
    assert torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))
    assert torch.equal(out_k.view(torch.int32), ctbl.view(torch.int32))
    assert bool(torch.isnan(out_k[:, UNSET_COLS]).all())
    packed = torch.cat([flat_tables(pack_tree(btree)),
                        torch.zeros(1, 16, device=dev)])[src.long()]
    assert torch.equal(out_k[:, NODE_COLS], packed[:, NODE_COLS])
    del packed
    ms = cuda_ms(lambda: gather_nodes(btree, src), 10)
    plain_ms = cuda_ms(lambda: gather_nodes_plain(btree, src), 3)
    flat = src.long()

    def library():
        tbl = flat_tables(pack_tree(btree))
        return torch.index_select(torch.cat(
            [tbl, torch.zeros(1, 16, device=dev)]), 0, flat)
    lib_ms = cuda_ms(library, 5)
    ops, nb = gather_nodes_work(btree.mac_rows.shape[0], src)
    print(f"kernel gather_nodes (compact table from the tree, main path): "
          f"rows {src.numel()} of {btree.mac_rows.shape[0]} nodes, columns "
          f"{NODE_COLS} bit-equal to flat_tables(pack_tree(tree))[src] "
          f"(the rest NaN, every column bit-equal to the plain version), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, pack_tree + "
          f"flat_tables + index_select {lib_ms:.4f} ms, bound "
          f"{bound_ms(ops, nb)[0]:.4f} ms [{card}]", flush=True)
    res.add("gather_nodes", 0.0, ms, plain_ms, ops, nb, lib_ms)
    tbl_all = flat_tables(pack_tree(btree))
    check_gather(res, "gather_rows", gather_rows, gather_rows_plain, tbl_all,
                 src, "compact table", card, gather_work, bound_ms)
    del lists, btree, ctbl, gt, xc, te, gc, tbl_all, src, sim, fkw, nkw
    del out_k, out_p, flat

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
    wl = {k: walk_launches[k] for k in ("far_level", "far_list",
                                         "near_level")}
    de = abs(sim_energy(wsim) - e_start) / abs(e_start)
    print(f"walk path (ListMode 0): N {n}, {WALK_STEPS} steps "
          f"{t_walk:.3f} s, {n * WALK_STEPS / t_walk:.1f} particle-steps/s, "
          f"|dE/E| {de:.3e}, launches {wl}, overflow {wovf} [{card}]",
          flush=True)
    assert wovf == 0 and de < 1e-3 and min(wl.values()) > 0, (wovf, de, wl)
    assert bool(torch.isfinite(wsim.particles.pos).all())
    del wsim

    # ---- this slice's path: flagship-dsmc ----------------------------------
    zero_counts()
    dsim, dsmc_times = dsmc_path(pos, vel, mass, n, dev, card)
    launches = read_counts()
    for key in ("range_walk", "sidm_emit", "sidm_emit_count",
                "segment_totals", "sidm_gated", "far_level_record",
                "far_list", "near_level", "gather_nodes"):
        assert launches[key] > 0, (key, launches)
    dsmc_kernels(res, dsim, dev, card)
    del dsim

    # ---- this slice's path: flagship-dsmc-walk ------------------------------
    zero_counts()
    wdsim = dsmc_walk_path(pos, vel, mass, n, dev, card)
    walk_dsmc_launches = read_counts()
    for key in ("far_level", "range_walk", "sidm_near",
                "sidm_emit_count", "segment_totals", "far_list",
                "near_level"):
        assert walk_dsmc_launches[key] > 0, (key, walk_dsmc_launches)
    # K4 on every DSMC step after prepare's (dt = 0 there: nothing gated)
    assert walk_dsmc_launches["sidm_near"] >= WALK_DSMC_STEPS, \
        walk_dsmc_launches
    dsmc_walk_kernels(res, wdsim, dev, card)
    del wdsim
    box_phase(res, dev, card)

    # ---- the run loop and the CLI: bench.py's run with the scatter log ------
    cli_launches = cli_path(pos, vel, mass, n, dev, card, dsmc_times,
                            zero_counts, read_counts)

    # ---- the single-program step: small-halo, its kernels, direct ---------
    from sidm_tpu_torch.flagship import small_config
    zero_counts()
    ssim, _ = small_run(small_config(), SMALL_STEPS, dev, card, "small-halo")
    small_launches = read_counts()
    for key in ("hash_knn", "hash_scan", "far_level", "far_list",
                "near_level"):
        assert small_launches[key] > 0, (key, small_launches)
    small_kernels(res, ssim, dev, card)
    del ssim
    zero_counts()
    dsim, _ = small_run(small_config(ForceMethod="direct"),
                        SMALL_DIRECT_STEPS, dev, card, "small-halo direct")
    direct_launches = read_counts()
    for key in ("hash_knn", "hash_scan", "direct"):
        assert direct_launches[key] > 0, (key, direct_launches)
    del dsim
    hash_rate(dev, card)

    # ---- individual timesteps and the velocity-dispersion pass -------------
    from sidm_tpu_torch.flagship import DSMC, SMALL_N, VELDISP
    zero_counts()
    vsim = veldisp_path(pos, vel, mass, n, dev, card)
    vd_launches = read_counts()
    for key in ("hash_knn", "veldisp", "near_level", "far_list",
                "far_level", "far_level_record", "gather_nodes"):
        assert vd_launches[key] > 0, (key, vd_launches)
    veldisp_kernels(res, vsim, dev, card)
    del vsim
    zero_counts()
    individual_run(flagship_config(**VELDISP), pos, vel, mass, n, dev, card,
                   "flagship-veldisp", VD_IND_STEPS)
    vd_ind_launches = read_counts()
    assert vd_ind_launches["veldisp"] > VD_IND_STEPS, vd_ind_launches
    zero_counts()
    drows = individual_run(flagship_config(**DSMC), pos, vel, mass, n, dev,
                           card, "flagship-dsmc", IND_STEPS)
    dsmc_ind_launches = read_counts()
    spos, svel, smass = flagship_ics(SMALL_N, SEED)
    zero_counts()
    srows = individual_run(small_config(), spos, svel, smass, SMALL_N, dev,
                           card, "small-halo", IND_STEPS, pad=256)
    small_ind_launches = read_counts()
    # steps that gate no DSMC target pass through the engines' early returns
    gated = [r["n_gated"] for r in drows + srows]
    print(f"individual DSMC steps: gated targets {gated}, launches "
          f"flagship-dsmc {dsmc_ind_launches}, small-halo "
          f"{small_ind_launches} [{card}]", flush=True)
    assert 0 in gated, gated

    # ---- periodic boxes, TreePM and comoving runs: cosmo-box ----------------
    zero_counts()
    csim = cosmo_path(dev, card)
    cosmo_launches = read_counts()
    print(f"cosmo-box launches {cosmo_launches} [{card}]", flush=True)
    for key in ("far_level_periodic", "far_list_periodic",
                "near_level_periodic"):
        assert cosmo_launches[key] > 0, (key, cosmo_launches)
    pm_times = pm_breakdown(csim, card)
    oracle_in = cosmo_oracle(csim, dev, card)
    pm_times["oracle"] = oracle_in[-1]
    cosmo_kernels(res, csim, oracle_in, dev, card)
    del csim, oracle_in
    torch.cuda.empty_cache()
    zero_counts()
    periodic_direct_run(dev, card)
    pdirect_launches = read_counts()
    assert pdirect_launches["direct_periodic"] > 0, pdirect_launches
    zero_counts()
    lattice_run(dev, card)
    lattice_launches = read_counts()
    for key in ("far_level_periodic", "far_list_periodic",
                "near_level_periodic"):
        assert lattice_launches[key] > 0, (key, lattice_launches)

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
        "gather_nodes": ("sidm_tpu_torch/csrc/gather.cu",
                         "scripts/pallas_gather_probe.py:40"),
        # the DSMC kernels have no TPU original: the JAX package's plain
        # XLA functions they port
        "range_walk": ("sidm_tpu_torch/csrc/range_walk.cu",
                       "sidm_tpu/ops/list_range.py:94"),
        "sidm_emit": ("sidm_tpu_torch/csrc/sidm_emit.cu",
                      "sidm_tpu/ops/list_range.py:205"),
        "sidm_emit_count": ("sidm_tpu_torch/csrc/sidm_emit.cu",
                            "sidm_tpu/ops/fused_range.py:179"),
        "sidm_gated": ("sidm_tpu_torch/csrc/sidm_gated.cu",
                       "sidm_tpu/ops/list_range.py:434"),
        "sidm_near": ("sidm_tpu_torch/csrc/sidm_near.cu",
                      "sidm_tpu/ops/fused_range.py:127"),
        # the DSMC kernels' schedule: JAX length-sorts the emission's groups
        "segment_totals": ("sidm_tpu_torch/csrc/work_items.cuh",
                           "sidm_tpu/ops/list_range.py:230"),
        # the single-program step's kernels: plain XLA in JAX
        "hash_knn": ("sidm_tpu_torch/csrc/hash_knn.cu",
                     "sidm_tpu/ops/neighbors.py:203"),
        "hash_scan": ("sidm_tpu_torch/csrc/hash_scan.cu",
                      "sidm_tpu/ops/sidm.py:221"),
        "direct": ("sidm_tpu_torch/csrc/direct.cu",
                   "sidm_tpu/ops/direct.py:33"),
        "veldisp": ("sidm_tpu_torch/csrc/hash_veldisp.cu",
                    "sidm_tpu/ops/veldisp.py:26"),
        # the periodic modes (slice 12): the TPU kernels they extend; JAX's
        # periodic walk runs these functions in XLA (``ports``)
        "far_level_periodic": ("sidm_tpu_torch/csrc/far_kernel.cu",
                               "sidm_tpu/ops/pallas_far.py:55"),
        "far_list_periodic": ("sidm_tpu_torch/csrc/far_list.cu",
                              "scripts/pallasfar.py:57"),
        "near_level_periodic": ("sidm_tpu_torch/csrc/near_kernel.cu",
                                "sidm_tpu/ops/pallas_near.py:30"),
        "direct_periodic": ("sidm_tpu_torch/csrc/direct.cu",
                            "sidm_tpu/ops/direct.py:33"),
    }
    ports = {"far_level_periodic": "sidm_tpu/ops/fused_force.py:427",
             "far_list_periodic": "sidm_tpu/ops/fused_force.py:488",
             "near_level_periodic": "sidm_tpu/ops/fused_force.py:350",
             "direct_periodic": "sidm_tpu/ops/direct.py:28,82,99"}
    kernels_json = []
    for name, (src_file, repl) in replaces.items():
        r = res.rows[name]
        bms, by = bound_ms(r["ops"], r["bytes"])
        by_path = {"lists": list_launches[name],
                   "walk": walk_launches[name], "dsmc": launches[name],
                   "dsmc_walk": walk_dsmc_launches[name],
                   "cli": cli_launches[name], "small": small_launches[name],
                   "small_direct": direct_launches[name],
                   "veldisp": vd_launches[name],
                   "veldisp_individual": vd_ind_launches[name],
                   "dsmc_individual": dsmc_ind_launches[name],
                   "small_individual": small_ind_launches[name],
                   "cosmo": cosmo_launches[name],
                   "periodic_direct": pdirect_launches[name],
                   "lattice": lattice_launches[name]}
        kernels_json.append({
            "name": name, "route": "cuda", "source": src_file,
            "replaces": repl, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": r["library_ms"],
            **{k: v for k, v in r.items() if k not in (
                "max_abs_err", "ms", "plain_ms", "ops", "bytes",
                "library_ms")},
            **({"device_time_notes": res.notes[name]}
               if name in res.notes else {}),
            **({"ports": ports[name]} if name in ports else {}),
            **({"cosmo_pm": pm_times} if name == "far_level_periodic"
               else {})})
    print(json.dumps({"kernels": kernels_json}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def check_gather(res, name, kern, plain, tbl, ids, label, card, gather_work,
                 bound_ms):
    """A gather kernel against its plain version (rows: bit-equal; row
    sums: 1e-6 of the largest), with times; for rows, one PyTorch call
    that computes the same function (index_select) as the yardstick."""
    rowsum = name == "gather_rowsum"
    out_k, out_p = kern(tbl, ids), plain(tbl, ids)
    max_abs = float(torch.max(torch.abs(out_k - out_p)))
    if rowsum:
        assert max_abs <= 1e-6 * float(torch.max(torch.abs(out_p))), max_abs
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


def frontier_widths(widths) -> str:
    """Per level of a range walk: the live frontier width's max, p99,
    median and mean over the groups, and the groups wider than the
    kernel's shared buffer (``fused_range.RANGE_SHARED_IDS``)."""
    from sidm_tpu_torch.ops.fused_range import RANGE_SHARED_IDS
    out = []
    for l, w in widths:
        q = torch.quantile(w, torch.tensor([0.5, 0.99], device=w.device))
        out.append(f"L{l} {int(w.max())}/{float(q[1]):.0f}/"
                   f"{float(q[0]):.0f}/{float(w.mean()):.1f}/"
                   f"{int(torch.sum(w > RANGE_SHARED_IDS))}")
    return " ".join(out)


def every_drop(label, stat, drops, paths):
    """The walk's drops on each of ``paths`` (of "open", "big_over",
    "big_drop", "seg_cap", "lvl_cap") counted and > 0."""
    from sidm_tpu_torch.ops.far_kernel import S_OVF_L, S_OVF_N
    got = {k: int(v) for k, v in drops.items()}
    got["seg_cap"] = int(stat[S_OVF_N].sum())
    got["lvl_cap"] = (int(stat[S_OVF_L].sum()) - got["open"]
                      - got["big_over"])
    assert all(got[k] > 0 for k in paths), (label, got)
    return got


def range_walk_check(res, card, kw, label, parent=None, **kernel_kw):
    """The one-launch range walk (``range_segments`` on the card, with
    ``kernel_kw``) against the plain walk (``range_walk_plain``) on the
    same inputs ``kw`` (range_segments' arguments): keys with their IMAX
    tails, counts, ovf, need, telemetry and the drops bit-equal, and one
    ``far_level.range_launches``; the live frontier widths per level
    printed. Timed: the walk kernel's device time and all the call's
    kernels' (torch.profiler), the call by CUDA events, the plain walk;
    with its bound and the parent design's (device, call) times
    ``parent``. Returns (times, the kernel's outputs, its drops)."""
    from sidm_tpu_torch.bounds import (bound_ms, range_level_rows,
                                       range_walk_work)
    from sidm_tpu_torch.ops.far_kernel import far_level
    from sidm_tpu_torch.ops.fused_range import (range_segments,
                                                range_walk_plain)
    levels, widths = [], []

    def observe(l, lk):
        levels.append(range_level_rows(lk))
        widths.append((l, torch.clamp(lk["n_live"], max=lk["fids"].shape[1])
                       .float()))
    dp, dk = {}, {}
    ref = range_walk_plain(**kw, drops=dp, on_level=observe)
    n0 = far_level.range_launches
    got = range_segments(**kw, drops=dk, **kernel_kw)
    assert far_level.range_launches == n0 + 1, (label, "one launch a walk")
    for name, a, b in zip(("keys", "nn", "ovf", "need", "stat"), got, ref):
        assert a.shape == b.shape and torch.equal(a, b), (label, name)
    dks = {k: int(v) for k, v in dk.items()}
    assert dks == {k: int(v) for k, v in dp.items()}, (label, dks, dp)
    ng = kw["glo"].shape[0]
    cfg = kw.get("cfg")
    print(f"range walk ({label}; {ng} groups, seg_cap {kw['seg_cap']}, "
          f"lvl_cap {kw.get('lvl_cap')}, caps "
          f"{tuple(cfg) if cfg else 'default'}"
          + "".join(f", {k} {v}" for k, v in kernel_kw.items())
          + f"): keys, counts, ovf {int(ref[2])}, need {int(ref[3])}, "
          f"telemetry and "
          f"drops {dks} bit-equal to the plain walk; live frontier widths "
          f"per level (max/p99/median/mean/groups past the shared buffer): "
          f"{frontier_widths(widths)} [{card}]", flush=True)
    run = lambda: range_segments(**kw, **kernel_kw)    # noqa: E731
    # the walk kernel is the call's only kernel (a memset of its 5 totals
    # beside it)
    t = dict(zip(("ms", "ms_by"), device_time(run, 5, ("range_walk_kernel",),
                                              whole=True)),
             all_ms=device_time(run, 5, ("",), whole=True)[0],
             call_ms=cuda_ms(run, 10),
             plain_ms=cuda_ms(lambda: range_walk_plain(**kw), 1))
    t["ops"], t["bytes"] = range_walk_work(levels, ng, kw["seg_cap"])
    t["bound_ms"], by = bound_ms(t["ops"], t["bytes"])
    par = "" if parent is None else (
        f" (parent design, this script on the tree before the redesign, "
        f"PR 8's run: its far_level launches {parent[0]:.3f} ms of device "
        f"time" + ("" if parent[1] is None else
                   f", their calls {parent[1]:.3f} ms") + ")")
    print(f"kernel range_walk ({label}, one launch, {len(levels)} levels): "
          f"device {t['ms']:.4f} ms ({t['ms_by']}), all the call's kernels "
          f"{t['all_ms']:.4f} ms, call {t['call_ms']:.4f} ms by CUDA "
          f"events{par}; plain {t['plain_ms']:.3f} ms; bound "
          f"{t['bound_ms']:.4f} ms ({by}: {sum(c for c, _ in levels)} "
          f"classified cells, {sum(d for _, d in levels)} distinct rows, "
          f"({ng}, {kw['seg_cap']}) keys), at {t['bound_ms'] / t['ms']:.1%} "
          f"of the bound's speed; ptxas {usage_of('range_walk_kernel')} "
          f"[{card}]", flush=True)
    if t["ms_by"] != "torch.profiler":
        res.note("range_walk", label, t["ms_by"])
    return t, got, dks


def dsmc_path(pos, vel, mass, n, dev, card):
    """flagship-dsmc through Simulation: prepare, compute_potential, STEPS
    steps, compute_potential, with the asserts of phase 9. Returns the
    Simulation."""
    from sidm_tpu_torch.flagship import DSMC, flagship_config
    from sidm_tpu_torch.simulation import Simulation

    sim = Simulation(flagship_config(**DSMC), mode="phased", device=dev)
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(n, np.int32),
                                  pad_to_multiple=4096)
    t0 = time.perf_counter()
    sim.prepare()
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    infos = [dict(sim.last_sidm_info, kind=sim.last_list_info["kind"])]
    prep_walls = dict(sim.last_phase_wall)
    sim.compute_potential()
    e_start = sim_energy(sim)
    ovf, walls, scat, times = 0, [], [], [sim.time]
    t0 = time.perf_counter()
    for _ in range(STEPS):
        _, _, n_scat = sim.step()
        times.append(sim.time)
        li, si = dict(sim.last_list_info), dict(sim.last_sidm_info)
        infos.append(dict(si, kind=li["kind"]))
        if li["ovf"] is not None:
            ovf += sum(li["ovf"])
        if sim.last_walk_info is not None:
            ovf += sum(int(sim.last_walk_info[k]) for k in
                       ("ovf_open", "ovf_big", "ovf_items"))
        m = sim.particles.mass[:, None].double()
        kick = si["kick"].double()
        mom = float(torch.linalg.norm(torch.sum(m * kick, 0)))
        scale = float(torch.sum(m * torch.linalg.norm(kick, dim=1,
                                                      keepdim=True)))
        assert mom <= 1e-5 * scale, ("momentum", mom, scale)
        scat.append(n_scat)
        walls.append((li, si, dict(sim.last_phase_wall), mom, scale))
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    sim.compute_potential()
    torch.cuda.synchronize()
    de = abs(sim_energy(sim) - e_start) / abs(e_start)
    finite = all(bool(torch.isfinite(getattr(sim.particles, f)).all())
                 for f in ("pos", "vel", "hsml_vd", "dvel"))
    print(f"flagship-dsmc prepare: {t_prep:.3f} s ("
          + ", ".join(f"{ph} {s * 1e3:.1f} ms" for ph, s in
                      prep_walls.items())
          + f"), candidate ovf {infos[0]['cand_ovf']}, need "
          f"{infos[0]['cand_need']} [{card}]", flush=True)
    for k, (li, si, w, mom, scale) in enumerate(walls):
        md = "-" if li["md"] is None else f"{li['md']:.4g}"
        print(f"dsmc step {k + 1} ({li['kind']}"
              + (", candidate record" if si["record"] else "") + "): "
              + ", ".join(f"{ph} {s * 1e3:.1f} ms" for ph, s in w.items())
              + f", skin {li['skin']:.4g}, md {md}, scatters {si['n_scat']}"
              f" of {si['proposals']} proposals ({si['rounds']} resolver "
              f"rounds), gated {si['n_gated']}, candidate ovf "
              f"{si['cand_ovf']} need {si['cand_need']}, gated/tail drops "
              f"{si['ovf_g']}, |sum m dv| {mom:.3e} of sum m|dv| "
              f"{scale:.3e} [{card}]", flush=True)
    records = [i for i in infos if i["record"]]
    kinds = [i["kind"] for i in infos]
    rcfg = sim._sidm_rcfg
    rate = n * STEPS / t_steps
    print(f"DSMC path (flagship-dsmc, ListMode 1, SIDMOn 1): N {n}, "
          f"{STEPS} steps {t_steps:.3f} s, {rate:.1f} particle-steps/s over "
          f"step kinds {kinds[1:]} (prepare's {kinds[0]}), candidate "
          f"records {len(records)}, scatters {scat} (total {sum(scat)}), "
          f"K {rcfg.k_cap}, seg_cap {rcfg.seg_cap}, tail_cap "
          f"{rcfg.tail_cap}, gated_frac {rcfg.gated_frac}, "
          f"sidm_trunc_frac {sim.sidm_trunc_frac:.3e} "
          f"({sim.sidm_trunc_targets} targets), t = {sim.time:.6g}, "
          f"|dE/E| {de:.3e}, force overflow {ovf}, finite {finite} "
          f"[{card}]", flush=True)
    assert finite and ovf == 0 and de < 1e-3, (finite, ovf, de)
    assert len(records) >= 2 and sum(scat) > 0, (len(records), scat)
    for i in records:
        assert i["cand_ovf"][0] == 0, i["cand_ovf"]
        assert i["cand_ovf"][1] == 0 or rcfg.k_cap >= sim.SIDM_K_CEILING
    assert all(i["ovf_g"] == [0, 0] for i in infos), "gated/tail drops"
    return sim, times


def dsmc_kernels(res, sim, dev, card):
    """K1-K3 against their plain versions on the DSMC run's end state: the
    range walk of a record and of a prepare pass (every level, all groups,
    bit-equal, timed), the emission and its count mode on EMIT_GROUPS
    groups at the run's K and at EMIT_TINY_K (bit-equal; the kernel timed
    on all groups), the gated tile on the next step's targets."""
    from sidm_tpu_torch import integrate
    from sidm_tpu_torch.bounds import (bound_ms, emit_work,
                                       segment_totals_work)
    from sidm_tpu_torch.ops.fused_force import (FusedConfig, default_depth,
                                                make_windows)
    from sidm_tpu_torch.ops.fused_range import (group_targets,
                                                range_levels,
                                                range_segments,
                                                segment_totals,
                                                segment_totals_plain)
    from sidm_tpu_torch.ops.list_range import (
        count_neighbours, gated_targets, record_candidates_from_particles,
        sidm_emit, sidm_emit_plain, sidm_gated, sidm_gated_plain,
        sidm_scatter_lists)
    from sidm_tpu_torch.ops.tree import build_octree
    from sidm_tpu_torch.rng import step_key

    p = sim.particles
    n = p.n_padded
    params = sim._sidm_params()
    mass = torch.where(p.valid, p.mass, torch.zeros_like(p.mass))
    eps = sim._softening()[torch.clamp(p.ptype, 0, 5).long()]
    tree = build_octree(p.pos, mass, eps, p.valid,
                        depth=default_depth(n))
    captured, walks = {}, []
    cands = record_candidates_from_particles(
        p, p.pos, tree, skin=sim._skin_now, params=params,
        rcfg=sim._sidm_rcfg, on_walk=walks.append,
        on_emit=lambda kw: captured.update(kw))
    torch.cuda.synchronize()
    t, _, _ = range_walk_check(res, card, walks[0], "a record",
                               PARENT_RANGE["record"])
    res.add("range_walk", 0.0, t["ms"], t["plain_ms"], t["ops"], t["bytes"])
    res.rows["range_walk"].update(
        call_ms=t["call_ms"], all_kernels_ms=t["all_ms"],
        ptxas=usage_of("range_walk_kernel"))
    # the caps cut small: every drop path in one walk, on a tree of the
    # same particles 3 levels shallower (the core's deepest cells overfull
    # there), and the frontier width alone in another (it counts as "open",
    # as open_cap does); and every frontier id through the global scratch
    # row
    rkw, shallow, d_small = walks[0], [], max(tree.depth - 3, 6)
    record_candidates_from_particles(
        p, p.pos, build_octree(p.pos, mass, eps, p.valid, depth=d_small),
        skin=sim._skin_now, params=params, rcfg=sim._sidm_rcfg,
        on_walk=shallow.append)
    for label, kw_small, paths in (
            (f"depth {d_small}, open_cap 16, big_cap 2, big_chunks 2, "
             "seg_cap 128, lvl_cap 64", dict(shallow[0], cfg=FusedConfig(
                 open_cap=16, big_cap=2, big_chunks=2), seg_cap=128,
                 lvl_cap=64),
             ("open", "big_over", "big_drop", "seg_cap", "lvl_cap")),
            ("w_max 128", dict(rkw, cfg=FusedConfig(w_max=128)), ("open",))):
        _, got, dks = range_walk_check(res, card, kw_small,
                                       f"a record's, caps {label}")
        print(f"  drops by path: {every_drop(label, got[4], dks, paths)}",
              flush=True)
    t, _, _ = range_walk_check(res, card, rkw, "a record, shared_ids 0",
                               shared_ids=0)
    res.rows["range_walk"].update(global_frontier_ms=t["ms"])
    # a prepare pass: pad = the largest h of the group, no skin
    col = p.is_collisionless & p.valid
    h_s = torch.where(col, p.hsml_vd, torch.zeros_like(p.hsml_vd))[tree.perm]
    typ = torch.where(col, p.ptype, torch.full_like(p.ptype, -9))[tree.perm]
    pidx, gvalid = make_windows(tree.keys_s, p.valid[tree.perm], n,
                                tree.depth)
    gt, gh, gty, gidx, glo, ghi, pad = group_targets(tree, pidx, gvalid, h_s,
                                                     typ)
    rlev = range_levels(tree)
    need = int(range_segments(tree, rlev, glo, ghi, pad, seg_cap=1024)[3])
    t, (keys, nn, _, _, stat), _ = range_walk_check(
        res, card, dict(tree=tree, rlev=rlev, glo=glo, ghi=ghi, pad=pad,
                        seg_cap=-(-need // 1024) * 1024),
        "a prepare pass", PARENT_RANGE["prepare pass"])
    assert int(stat[4].sum()) == 0, "prepare pass segment drops"
    res.rows["range_walk"].update(
        prepare_pass_ms=t["ms"], prepare_pass_call_ms=t["call_ms"],
        prepare_pass_bound_ms=t["bound_ms"],
        prepare_pass_plain_ms=t["plain_ms"])

    # the groups' staged particles (the DSMC kernels' schedule), kernel vs
    # plain on a record's and a prepare pass's segment lists
    kw = captured
    ng = kw["keys"].shape[0]
    tot = segment_totals(kw["keys"], kw["nn"])
    tot_c = segment_totals(keys, nn)
    assert torch.equal(tot, segment_totals_plain(kw["keys"], kw["nn"]))
    assert torch.equal(tot_c, segment_totals_plain(keys, nn))
    ms = cuda_ms(lambda: segment_totals(kw["keys"], kw["nn"]), 10)
    plain_ms = cuda_ms(lambda: segment_totals_plain(kw["keys"], kw["nn"]), 3)
    ops, nb = segment_totals_work(kw["keys"], kw["nn"])
    bms, by = bound_ms(ops, nb)
    print(f"kernel segment_totals (a record's {ng} groups, keys "
          f"{tuple(kw['keys'].shape)}, {int(kw['nn'].sum())} live): "
          f"bit-equal to the plain version, here and on a prepare pass's "
          f"lists ({int(nn.sum())} live keys); staged particles per group "
          f"sum {int(tot.sum())} max {int(tot.max())} (prepare pass: sum "
          f"{int(tot_c.sum())} max {int(tot_c.max())}); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), at "
          f"{bms / ms:.1%} of the bound's speed; ptxas "
          f"{usage_of('cover_count')} [{card}]", flush=True)
    res.add("segment_totals", 0.0, ms, plain_ms, ops, nb)
    res.rows["segment_totals"].update(ptxas=usage_of("cover_count"))

    # K2: emission and count mode, kernel vs plain on a subset of groups
    # (spread over the index range, and the longest)
    sub = with_longest(subset(ng, EMIT_GROUPS, dev), tot)
    skw = {k: (v[sub].contiguous() if k in ("keys", "nn", "gt", "gr", "gty",
                                            "gidx") else v)
           for k, v in kw.items()}
    base = [skw[k] for k in ("keys", "nn", "src", "gt", "gr", "gty",
                             "gidx")]
    for K in (kw["K"], EMIT_TINY_K):
        a = sidm_emit(*base, n, K)
        b = sidm_emit_plain(*base, n, K)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), ("emit", K)
        ovf_k = int(torch.sum(torch.clamp(b[2].long() - K, min=0)))
        print(f"kernel sidm_emit ({len(sub)} of {ng} groups, the {LONGEST} "
              f"longest among them, K {K}): candidate lists (every row, "
              f"those no slot owns included), ncand and demand bit-equal "
              f"to the plain version's, {int(torch.sum(b[1]))} candidates, "
              f"K drops {ovf_k} [{card}]", flush=True)
        if K == EMIT_TINY_K:
            assert ovf_k > 0
    sub_c = with_longest(subset(ng, EMIT_GROUPS, dev), tot_c)
    cargs = dict(keys=keys[sub_c].contiguous(), nn=nn[sub_c].contiguous(),
                 src=kw["src"], gt=gt[sub_c].contiguous(),
                 gh=gh[sub_c].contiguous(), gty=gty[sub_c].contiguous(),
                 gidx=gidx[sub_c].contiguous(), n=n)
    ck = count_neighbours(**cargs)
    cp = sidm_emit_plain(*[cargs[k] for k in ("keys", "nn", "src", "gt",
                                              "gh", "gty", "gidx")], n, 0,
                         count_mode=True)
    assert torch.equal(ck, cp), "count mode"
    K = kw["K"]
    full = [kw[k] for k in ("keys", "nn", "src", "gt", "gr", "gty", "gidx")]
    ms = cuda_ms(lambda: sidm_emit(*full, n, K), 5)
    sub_ms = cuda_ms(lambda: sidm_emit(*base, n, K), 3)
    plain_ms = cuda_ms(lambda: sidm_emit_plain(*base, n, K), 1)
    cnt = {}
    ops, nb = emit_work(*full[:5], full[6], n, K, counts=cnt)
    bms, by = bound_ms(ops, nb)
    print(f"kernel sidm_emit (a record's emission, all {ng} groups, K {K}): "
          f"{ms:.3f} ms (parent {PARENT_MS['sidm_emit']:.3f} ms), bound "
          f"{bms:.3f} ms ({by}; the whole (n, K) output counted; "
          f"{pair_counts(cnt)}), at {bms / ms:.1%} of the bound's speed; "
          f"{len(sub)} groups: kernel {sub_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; ptxas {usage_of('sidm_emit_kernel')} "
          f"[{card}]", flush=True)
    res.add("sidm_emit", 0.0, ms, plain_ms, ops, nb)
    res.rows["sidm_emit"].update(subset_groups=len(sub), subset_ms=sub_ms,
                                 ptxas=usage_of("sidm_emit_kernel"), **cnt)
    call = [keys, nn, kw["src"], gt, gh, gty, gidx]
    ms = cuda_ms(lambda: count_neighbours(*call, n), 5)
    csub = [cargs[k] for k in ("keys", "nn", "src", "gt", "gh", "gty",
                               "gidx")]
    sub_ms = cuda_ms(lambda: count_neighbours(*csub, n), 3)
    plain_ms = cuda_ms(lambda: sidm_emit_plain(*csub, n, 0,
                                               count_mode=True), 1)
    cnt = {}
    ops, nb = emit_work(keys, nn, kw["src"], gt, gh, gidx, n,
                        count_mode=True, counts=cnt)
    bms, by = bound_ms(ops, nb)
    print(f"kernel sidm_emit count mode (a prepare pass, all {ng} groups): "
          f"counts on {len(sub_c)} groups (the {LONGEST} longest among "
          f"them) equal to the plain version's; {ms:.3f} ms (parent "
          f"{PARENT_MS['sidm_emit_count']:.3f} ms), bound {bms:.3f} ms "
          f"({by}; {pair_counts(cnt)}), at {bms / ms:.1%} of the bound's "
          f"speed; {len(sub_c)} groups: kernel {sub_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; ptxas {usage_of('sidm_emit_kernel')} "
          f"[{card}]", flush=True)
    res.add("sidm_emit_count", 0.0, ms, plain_ms, ops, nb)
    res.rows["sidm_emit_count"].update(
        subset_groups=len(sub_c), subset_ms=sub_ms,
        ptxas=usage_of("sidm_emit_kernel"), **cnt)
    del keys, nn, stat, captured, kw, skw, base, full, call, tot, tot_c

    # K3: the next step's gated tile, kernel vs plain
    t_next = torch.clamp(integrate.find_next_time(p), max=sim.cfg.TimeMax)
    active = integrate.active_mask(p, t_next)
    pos_pred, _ = integrate.predict_positions(p, t_next, sim.consts)
    vmax = torch.tensor(sim.vmax, dtype=pos_pred.dtype, device=dev)
    key = step_key(sim.root_key, sim.step_count)
    _, _, _, _, info = sidm_scatter_lists(
        p, pos_pred, tree, cands, t_next, active, vmax, key, params,
        rcfg=sim._sidm_rcfg, salt=sim.step_count)
    tid, drops = gated_targets(info["hs"], cands.ncand, cands.cand.shape[1],
                               info["ngc"], info["ntail"], info["kd"])
    drops = drops.tolist()
    gargs = (info["rows"], cands.cand, cands.ncand, info["hs"], info["dts"],
             tid, sim.step_count, t_next, info["sigma_co"], params)
    k = sidm_gated(*gargs)
    pl = sidm_gated_plain(*gargs)
    sel = tid[tid >= 0].long()
    assert torch.equal(k[1], pl[1]), "sidm_gated counts"
    rel = (torch.abs(k[0] - pl[0]) / torch.clamp(torch.abs(pl[0]),
                                                 min=1e-30))[sel]
    p999 = q999(rel)
    diff = (k[3] != pl[3])[sel]
    kk, pk = k[2][sel], pl[2][sel]
    near = diff & (torch.abs(kk - pk) <= 4 * torch.finfo(torch.float32).eps
                   * torch.clamp(torch.abs(pk), min=1.0))
    n_diff, n_tie = int(diff.sum()), int(near.sum())
    max_abs = float(torch.max(torch.abs(k[0] - pl[0])[sel]))
    t = gated_times(res, "the next step", gargs, tid, cands, k[1])
    print(f"kernel sidm_gated (the next step's {sel.numel()} gated targets, "
          f"drops {drops}; candidates per target {ncand_line(cands, sel)}): "
          f"counts equal, P_tot p99.9 rel err {p999:.3e}, max abs "
          f"{max_abs:.3e}, partners differing {n_diff} (near-ties "
          f"{n_tie}) of {int(torch.sum(pl[3][sel] >= 0))}; "
          f"{gated_line(t, PARENT_GATED['dsmc'])} [{card}]", flush=True)
    assert p999 < 1e-5 and n_diff == n_tie, (p999, n_diff, n_tie)
    res.add("sidm_gated", max_abs, t["ms"], t["plain_ms"], t["ops"],
            t["bytes"])
    res.rows["sidm_gated"].update(
        partner_near_ties=n_tie, p999_rel_err=p999, fill_ms=t["fill_ms"],
        tile_ms=t["tile_ms"], ptxas=usage_of("sidm_gated"))


def gated_times(res, label, gargs, tid, cands, cnt):
    """K3 timed as one call, the fill included (CUDA events), its device
    time split between the fill and the tile (torch.profiler; None where
    it saw neither, noted in ``res``), the plain version and the bound."""
    from sidm_tpu_torch.bounds import bound_ms, gated_work
    from sidm_tpu_torch.ops.list_range import sidm_gated, sidm_gated_plain
    run = lambda: sidm_gated(*gargs)    # noqa: E731
    (fill, fill_by), (tile, tile_by) = (
        device_time(run, 10, (k,), whole=False)
        for k in ("sidm_gated_fill", "sidm_gated_kernel"))
    for part, how in (("fill", fill_by), ("tile", tile_by)):
        if how != "torch.profiler":
            res.note("sidm_gated", f"{label}, {part}", how)
    t = dict(ms=cuda_ms(run, 10), fill_ms=fill, tile_ms=tile,
             plain_ms=cuda_ms(lambda: sidm_gated_plain(*gargs), 2))
    t["ops"], t["bytes"] = gated_work(tid, cands.ncand, cnt, cands.cand)
    t["bound_ms"], t["by"] = bound_ms(t["ops"], t["bytes"])
    return t


def gated_line(t, parent):
    return (f"one call {t['ms']:.4f} ms by CUDA events (device: fill "
            f"{fmt_ms(t['fill_ms'])}, tile {fmt_ms(t['tile_ms'])}; parent "
            f"design, this script on the tree before the redesign, PR 8's "
            f"run: one call {parent:.4f} ms), plain {t['plain_ms']:.3f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['by']}), at "
            f"{t['bound_ms'] / t['ms']:.1%} of the bound's speed; ptxas "
            f"{usage_of('sidm_gated')}")


def ncand_line(cands, sel) -> str:
    c = cands.ncand[sel].float()
    q = torch.quantile(c, torch.tensor([0.1, 0.5, 0.9], device=c.device))
    return (f"mean {float(c.mean()):.1f}, p10/p50/p90 "
            f"{'/'.join(f'{float(x):.0f}' for x in q)}, max {int(c.max())}")


def one_and_all_live(near, g):
    """Group g's per-group arguments as two extra groups: one with only its
    first live slot live, one with its live slots cycled over all 64."""
    from sidm_tpu_torch.ops.fused_range import G
    live = torch.nonzero((near["gidx"][g] >= 0)
                         & (near["gh"][g] > 0)).flatten()
    one, every = {}, {}
    for k in ("keys", "nn", "gt", "gv", "gh", "gdt", "gty", "gidx"):
        v = near[k][g]
        every[k] = v if k in ("keys", "nn") else \
            v[live[torch.arange(G, device=v.device) % live.numel()]]
        dead = {"gidx": -1, "gty": -9}.get(k, 0)
        one[k] = v if k in ("keys", "nn") else torch.where(
            (torch.arange(G, device=v.device) == live[0]).reshape(
                (G,) + (1,) * (v.dim() - 1)), v, torch.full_like(v, dead))
    return one, every


def near_check(res, near, sub, card, label, box=False):
    """K4 (``sidm_near``) against ``sidm_near_plain`` on the groups
    ``sub`` of one call's arguments ``near``, the LONGEST longest groups
    and two made from the longest: one with a single live slot and one with
    all 64 live. Counts equal, P_tot p99.9 relative error < 1e-5, partners
    equal except at near-ties (best keys within 4 float32 ULPs); the kernel
    timed on all groups against its bound (the plain version on the
    subset), with the workload it staged. The times of a ``box`` call go
    into the JSON row's ``box_*`` keys."""
    from sidm_tpu_torch.bounds import bound_ms, near_dsmc_work
    from sidm_tpu_torch.ops.fused_range import (IMAX, NEAR_PIECE,
                                                live_slots, near_pairs,
                                                segment_totals,
                                                segment_totals_plain,
                                                sidm_near, sidm_near_plain)
    from sidm_tpu_torch.ops.work_items import item_cap, plan_items
    per_group = ("keys", "nn", "gt", "gv", "gh", "gdt", "gty", "gidx")
    tot = segment_totals(near["keys"], near["nn"])
    assert torch.equal(tot, segment_totals_plain(near["keys"], near["nn"]))
    nlive = live_slots(near["gidx"], near["gh"])
    sub = with_longest(sub, tot)
    one, every = one_and_all_live(near, int(torch.argmax(
        torch.where(nlive > 0, tot, torch.full_like(tot, -1)))))
    skw = {k: (torch.cat([v[sub], one[k][None], every[k][None]])
               if k in per_group else v) for k, v in near.items()}
    k = sidm_near(**skw)
    pl = sidm_near_plain(**skw)
    live = (skw["gidx"] >= 0) & (skw["gh"] > 0)
    assert live_slots(skw["gidx"], skw["gh"])[-2:].tolist() == [1, 64]
    assert torch.equal(k[1], pl[1]), ("sidm_near counts", label)
    rel = (torch.abs(k[0] - pl[0]) / torch.clamp(torch.abs(pl[0]),
                                                 min=1e-30))[live]
    p999 = q999(rel)
    diff = (k[3] != pl[3])[live]
    kk, pk = k[2][live], pl[2][live]
    tie = diff & (torch.abs(kk - pk) <= 4 * torch.finfo(torch.float32).eps
                  * torch.clamp(torch.abs(pk), min=1.0))
    n_diff, n_tie = int(diff.sum()), int(tie.sum())
    max_abs = float(torch.max(torch.abs(k[0] - pl[0])[live])) \
        if bool(live.any()) else 0.0
    ng = near["keys"].shape[0]
    msg = (f"kernel sidm_near ({label}; {len(sub)} of {ng} groups, the "
           f"{LONGEST} longest among them, and two made from the longest "
           f"with 1 and 64 live slots; {int(live.sum())} gated slots, "
           f"{int(torch.sum(pl[1]))} pairs): counts equal, P_tot p99.9 rel "
           f"err {p999:.3e}, max abs {max_abs:.3e}, partners differing "
           f"{n_diff} (near-ties {n_tie}) of "
           f"{int(torch.sum(pl[3][live] >= 0))}")
    assert p999 < 1e-5 and n_diff == n_tie, (label, p999, n_diff, n_tie)
    ms = cuda_ms(lambda: sidm_near(**near), 10)
    sub_ms = cuda_ms(lambda: sidm_near(**skw), 10)
    plain_ms = cuda_ms(lambda: sidm_near_plain(**skw), 1)
    full = sidm_near(**near)
    ops, nb = near_dsmc_work(near["keys"], near["nn"], near["gidx"],
                             near["gh"], full[1])
    bms, by = bound_ms(ops, nb)
    parent = PARENT_MS["sidm_near_box" if box else "sidm_near"]
    work = dict(keys_sum=int(torch.sum(torch.clamp(
                    near["nn"], min=0, max=near["keys"].shape[1]))),
                staged_sum=int(tot.sum()), staged_max=int(tot.max()),
                live_sum=int(nlive.sum()), live_max=int(nlive.max()),
                slot_pairs=int(torch.sum(tot.long() * nlive.long())),
                heaviest_pairs=int(torch.max(tot.long() * nlive.long())),
                groups_one_live=int(torch.sum(nlive == 1)),
                groups_all_live=int(torch.sum(nlive == 64)))
    # the kernel's work items: items_plan's plain version (held to the
    # card's items_plan by the near_level and far_list checks) on the
    # same weights; printed, not in the JSON line
    _, off, _ = plan_items(near_pairs(near["keys"], near["nn"],
                                      near["gidx"], near["gh"]), IMAX,
                           item_cap(ng), NEAR_PIECE)
    n_it = off[1:] - off[:-1]
    print(msg + f"; all groups: kernel {ms:.4f} ms (parent {parent:.4f} "
          f"ms), bound {bms:.4f} ms ({by}), at {bms / ms:.1%} of the "
          f"bound's speed; segment keys {work['keys_sum']}, staged "
          f"particles per group sum {work['staged_sum']} max "
          f"{work['staged_max']}, live slots sum "
          f"{work['live_sum']} max {work['live_max']} (groups with 1: "
          f"{work['groups_one_live']}, with 64: "
          f"{work['groups_all_live']}), (live slot, staged particle) pairs "
          f"{work['slot_pairs']} (heaviest group {work['heaviest_pairs']}), "
          f"work items {int(off[-1])} ({int(torch.sum(n_it > 1))} groups "
          f"cut, into at most {int(n_it.max())}); subset: kernel "
          f"{sub_ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms; ptxas {usage_of('sidm_near_kernel')} "
          f"[{card}]", flush=True)
    if box:
        res.add("sidm_near", max_abs, 0.0, 0.0, 0.0, 0.0)
        side_row(res, "sidm_near", box_ms=ms, box_bound_ms=bms,
                box_plain_ms=plain_ms, box_subset_ms=sub_ms,
                box_p999_rel_err=p999)
        return
    res.add("sidm_near", max_abs, ms, plain_ms, ops, nb)
    res.rows["sidm_near"].update(p999_rel_err=p999,
                                 partner_near_ties=n_tie,
                                 subset_groups=len(sub) + 2,
                                 subset_ms=sub_ms, groups=ng,
                                 pairs=int(torch.sum(full[1])),
                                 ptxas=usage_of("sidm_near_kernel"), **work)


def side_row(res, name, **times):
    """A kernel's times on another input (the periodic box, another
    walk), beside its main-path row."""
    res.add(name, 0.0, 0.0, 0.0, 0.0, 0.0)
    res.rows[name].update(**times)


def subset(ng, k, dev):
    return torch.unique(torch.linspace(0, max(ng - 1, 0), min(k, ng),
                                       device=dev).long())


def dsmc_walk_path(pos, vel, mass, n, dev, card):
    """flagship-dsmc-walk (the walk every step, DSMC on the range walk)
    through Simulation: prepare, compute_potential, WALK_DSMC_STEPS steps,
    compute_potential, with the asserts of phase 10. Returns the
    Simulation."""
    from sidm_tpu_torch.flagship import DSMC_WALK, flagship_config
    from sidm_tpu_torch.simulation import Simulation

    sim = Simulation(flagship_config(**DSMC_WALK), mode="phased", device=dev)
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(n, np.int32),
                                  pad_to_multiple=4096)
    t0 = time.perf_counter()
    sim.prepare()
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    sim.compute_potential()
    e_start = sim_energy(sim)
    ovf, scat, drops = 0, [], []
    t0 = time.perf_counter()
    for k in range(WALK_DSMC_STEPS):
        _, _, n_scat = sim.step()
        si, wi = dict(sim.last_sidm_info), sim.last_walk_info
        ovf += sum(int(wi[f]) for f in ("ovf_open", "ovf_big", "ovf_items"))
        m = sim.particles.mass[:, None].double()
        kick = si["kick"].double()
        mom = float(torch.linalg.norm(torch.sum(m * kick, 0)))
        scale = float(torch.sum(m * torch.linalg.norm(kick, dim=1,
                                                      keepdim=True)))
        assert mom <= 1e-5 * scale, ("momentum", mom, scale)
        assert si["engine"] == "walk", si["engine"]
        scat.append(n_scat)
        drops.append(si["walk_ovf"])
        print(f"dsmc-walk step {k + 1} "
              f"({'rebuild' if sim.last_step_rebuilt else 'refresh'}): "
              + ", ".join(f"{ph} {s * 1e3:.1f} ms" for ph, s in
                          sim.last_phase_wall.items())
              + f", scatters {n_scat} of {si['proposals']} proposals, gated "
              f"{si['n_gated']} in {si['groups']} groups (segment cap "
              f"{si['seg_cap']}, walk caps (w_max, open_cap, big_cap, "
              f"big_chunks) {si['walk_caps']}), walk drops (cells, big, "
              "segments) "
              f"{si['walk_ovf']}, |sum m dv| {mom:.3e} of sum m|dv| "
              f"{scale:.3e} [{card}]", flush=True)
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    sim.compute_potential()
    torch.cuda.synchronize()
    de = abs(sim_energy(sim) - e_start) / abs(e_start)
    finite = all(bool(torch.isfinite(getattr(sim.particles, f)).all())
                 for f in ("pos", "vel", "hsml_vd", "dvel"))
    print(f"DSMC walk path (flagship-dsmc-walk, ListMode 0, SIDMOn 1): N {n}, "
          f"prepare {t_prep:.3f} s, {WALK_DSMC_STEPS} steps {t_steps:.3f} s, "
          f"{n * WALK_DSMC_STEPS / t_steps:.1f} particle-steps/s, scatters "
          f"{scat} (total {sum(scat)}), walk drops {drops}, force overflow "
          f"{ovf}, t = {sim.time:.6g}, |dE/E| {de:.3e}, finite {finite} "
          f"[{card}]", flush=True)
    assert finite and ovf == 0 and de < 1e-3, (finite, ovf, de)
    assert sum(scat) > 0, scat
    assert all(d == [0, 0, 0] for d in drops), drops
    return sim


def dsmc_walk_kernels(res, sim, dev, card):
    """K4 on the DSMC walk run's end state: the next step's segment pass
    against its plain version on a subset of the gated groups, timed on
    all of them."""
    from sidm_tpu_torch import integrate
    from sidm_tpu_torch.ops.fused_force import default_depth
    from sidm_tpu_torch.ops.fused_range import sidm_scatter_fused
    from sidm_tpu_torch.ops.tree import build_octree
    from sidm_tpu_torch.rng import step_key

    p = sim.particles
    t_next = torch.clamp(integrate.find_next_time(p), max=sim.cfg.TimeMax)
    active = integrate.active_mask(p, t_next)
    pos_pred, _ = integrate.predict_positions(p, t_next, sim.consts)
    mass = torch.where(p.valid, p.mass, torch.zeros_like(p.mass))
    eps = sim._softening()[torch.clamp(p.ptype, 0, 5).long()]
    tree = build_octree(pos_pred, mass, eps, p.valid,
                        depth=default_depth(p.n_padded))
    vmax = torch.tensor(sim.vmax, dtype=pos_pred.dtype, device=dev)
    near, walks = {}, []
    sidm_scatter_fused(p, pos_pred, tree, t_next, active, vmax,
                       step_key(sim.root_key, sim.step_count),
                       sim._sidm_params(), cfg=sim._walk_fcfg,
                       salt=sim.step_count, seg_cap=sim._walk_seg_cap,
                       on_walk=walks.append, on_near=near.update)
    t, _, _ = range_walk_check(res, card, walks[-1],
                               "flagship-dsmc-walk's next step")
    side_row(res, "range_walk",
            walk_step_ms=t["ms"], walk_step_call_ms=t["call_ms"],
            walk_step_bound_ms=t["bound_ms"])
    ng = near["keys"].shape[0]
    near_check(res, near, subset(ng, SUBSET_GROUPS, dev), card,
               "flagship-dsmc-walk's next step")


def box_phase(res, dev, card):
    """Phase 10 on a periodic uniform box (the rate harness's, N =
    BOX_N): K1's range mode and K2 bit-equal to their plain versions with
    the box, K3 and K4 at phase 9's bars; one step of each engine on the
    same inputs (equal counts, partners equal except at near-ties); the
    short rate check of both engines. Returns nothing; asserts."""
    from sidm_tpu_torch import validate_rate as vr
    from sidm_tpu_torch.bounds import bound_ms, emit_work
    from sidm_tpu_torch.ops.fused_range import (segment_totals,
                                                sidm_scatter_fused)
    from sidm_tpu_torch.ops.list_range import (
        count_neighbours, gated_targets, record_candidates_from_particles,
        sidm_emit, sidm_emit_plain, sidm_gated, sidm_gated_plain,
        sidm_scatter_lists)
    from sidm_tpu_torch.rng import run_key, step_key
    import dataclasses

    box = vr.BOX
    t0 = time.perf_counter()
    p0, tree, _ = vr.make_box(BOX_N, dev)
    torch.cuda.synchronize()
    print(f"periodic box: N {BOX_N} uniform, hsml init with the box "
          f"{time.perf_counter() - t0:.3f} s, mean neighbours "
          f"{float(p0.ngb_vd[p0.valid].float().mean()):.2f} [{card}]",
          flush=True)
    params = vr.rate_params(0)
    # K1 and K2 with the box, each timed on all groups
    emit, walks = {}, []
    cands = record_candidates_from_particles(
        p0, p0.pos, tree, skin=0.0, params=params, box=box,
        on_walk=walks.append, on_emit=emit.update)
    assert cands.ovf.tolist() == [0, 0], cands.ovf
    t, _, _ = range_walk_check(res, card, walks[0],
                               "the rate box's record, periodic",
                               PARENT_RANGE["rate box"])
    side_row(res, "range_walk", box_ms=t["ms"], box_call_ms=t["call_ms"],
            box_bound_ms=t["bound_ms"], box_plain_ms=t["plain_ms"])
    ng = emit["keys"].shape[0]
    sub = with_longest(subset(ng, EMIT_GROUPS, dev),
                       segment_totals(emit["keys"], emit["nn"]))
    base = [emit[k][sub].contiguous() if k not in ("src",) else emit[k]
            for k in ("keys", "nn", "src", "gt", "gr", "gty", "gidx")]
    n = p0.n_padded
    for K in (emit["K"], EMIT_TINY_K):
        a = sidm_emit(*base, n, K, box=box)
        b = sidm_emit_plain(*base, n, K, box=box)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), ("emit box", K)
    assert torch.equal(count_neighbours(*base, n, box=box),
                       sidm_emit_plain(*base, n, 0, count_mode=True,
                                       box=box)), "count mode box"
    full = [emit[k] for k in ("keys", "nn", "src", "gt", "gr", "gty",
                              "gidx")]
    ms = cuda_ms(lambda: sidm_emit(*full, n, emit["K"], box=box), 3)
    plain_ms = cuda_ms(lambda: sidm_emit_plain(*base, n, emit["K"],
                                               box=box), 1)
    ops, nb = emit_work(*full[:5], full[6], n, emit["K"], box=box)
    bms, by = bound_ms(ops, nb)
    print(f"kernel sidm_emit with the periodic box (K {emit['K']} and "
          f"{EMIT_TINY_K}, count mode; {len(sub)} of {ng} groups, the "
          f"{LONGEST} longest among them): bit-equal to the plain version; "
          f"all groups {ms:.3f} ms (parent "
          f"{PARENT_MS['sidm_emit_box']:.3f} ms), bound {bms:.4f} ms "
          f"({by}), at {bms / ms:.1%} of the bound's speed; plain on "
          f"{len(sub)} groups {plain_ms:.3f} ms; ptxas "
          f"{usage_of('sidm_emit_kernel')} [{card}]", flush=True)
    side_row(res, "sidm_emit", box_ms=ms, box_bound_ms=bms,
            box_plain_ms=plain_ms)
    # one frozen pass of each engine: K3 and K4 vs plain, then the engines
    dt = vr.EVENT_FRACTION / vr.analytic_sigma_v(0, 1.0)
    p = dataclasses.replace(p0, current_time=torch.full_like(
        p0.current_time, 1.0 - dt / 2))
    t = torch.tensor(1.0, device=dev)
    vmax = torch.sqrt(torch.max(torch.sum(p.vel ** 2, -1)))
    key = step_key(run_key(7, 0), 0)
    near = {}
    _, ns_w, winfo = sidm_scatter_fused(p, p.pos, tree, t, p.valid, vmax,
                                        key, params, salt=0, box=box,
                                        return_info=True,
                                        on_near=near.update)
    assert [int(winfo[k]) for k in ("ovf_walk", "ovf_big", "ovf_seg")] \
        == [0, 0, 0]
    near_check(res, near, subset(near["keys"].shape[0], SUBSET_GROUPS, dev),
               card, "periodic box", box=True)
    _, ns_l, _, ovf_g, linfo = sidm_scatter_lists(
        p, p.pos, tree, cands, t, p.valid, vmax, key, params, salt=0,
        box=box)
    assert ovf_g.tolist() == [0, 0]
    tid, _ = gated_targets(linfo["hs"], cands.ncand, cands.cand.shape[1],
                           linfo["ngc"], linfo["ntail"], linfo["kd"])
    gargs = (linfo["rows"], cands.cand, cands.ncand, linfo["hs"],
             linfo["dts"], tid, 0, t, linfo["sigma_co"], params, box)
    k3, p3 = sidm_gated(*gargs), sidm_gated_plain(*gargs)
    sel = tid[tid >= 0].long()
    assert torch.equal(k3[1], p3[1]), "sidm_gated counts box"
    rel = (torch.abs(k3[0] - p3[0])
           / torch.clamp(torch.abs(p3[0]), min=1e-30))[sel]
    d3 = (k3[3] != p3[3])[sel]
    t3 = d3 & (torch.abs(k3[2] - p3[2])[sel]
               <= 4 * torch.finfo(torch.float32).eps
               * torch.clamp(torch.abs(p3[2][sel]), min=1.0))
    assert q999(rel) < 1e-5 and int(d3.sum()) == int(t3.sum())
    gt3 = gated_times(res, "the rate box", gargs, tid, cands, k3[1])
    side_row(res, "sidm_gated", box_ms=gt3["ms"], box_fill_ms=gt3["fill_ms"],
            box_tile_ms=gt3["tile_ms"], box_bound_ms=gt3["bound_ms"],
            box_plain_ms=gt3["plain_ms"])
    # the engines on the same pass: the same gated targets, pair sets and
    # keys
    gate = linfo["hs"] > 0
    assert torch.equal(gate, winfo["hs"] > 0)
    same_cnt = torch.equal(winfo["cnt"][gate], linfo["cnt"][gate])
    dj = (winfo["bestj"] != linfo["bestj"])[gate]
    gap = torch.abs(winfo["bestk"] - linfo["bestk"])[gate]
    tj = dj & (gap <= 4 * torch.finfo(torch.float32).eps
               * torch.clamp(torch.abs(linfo["bestk"][gate]), min=1.0))
    print(f"kernel sidm_gated with the periodic box ({sel.numel()} gated "
          f"targets; candidates per target {ncand_line(cands, sel)}): counts "
          f"equal, P_tot p99.9 rel err {q999(rel):.3e}, partners differing "
          f"{int(d3.sum())} (near-ties {int(t3.sum())}); "
          f"{gated_line(gt3, PARENT_GATED['rate box'])}; engines on one "
          f"pass: walk {int(ns_w)} and "
          f"lists {int(ns_l)} scatters, neighbour counts equal "
          f"{same_cnt} on {int(gate.sum())} gated targets, partners "
          f"differing {int(dj.sum())} (near-ties {int(tj.sum())}) [{card}]",
          flush=True)
    assert same_cnt and int(dj.sum()) == int(tj.sum())
    # the short rate check, hard sphere, both engines
    for eng in ("walk", "lists"):
        r = vr.run_type(p0, tree, 0, eng, RATE_PASSES, BOX_N)
        print(f"rate (hard sphere, N {BOX_N}, {RATE_PASSES} passes, {eng}): "
              f"events {r['events']}, expected {r['expected']:.1f}, ratio "
              f"{r['ratio']:.4f} +- {r['err']:.4f} "
              f"({'OK' if r['ok'] else 'FAIL'} at max(1 %, 3 sigma)), drops "
              f"{r['drops']}, {r['seconds']:.2f} s [{card}]", flush=True)
        assert r["ok"] and not any(r["drops"].values()), r


SMALL_STEPS = 4         # phase 12's small-halo run, after prepare
SMALL_DIRECT_STEPS = 2  # ... and with ForceMethod direct
SMALL_TARGETS = 4096    # H3's random targets against the plain sum
TIE = 1e-4              # H2: a uniform within this of a running sum


def small_run(cfg, steps: int, dev, card, label):
    """small-halo (``flagship.small_config``) at N = SMALL_N through
    Simulation on the single-program step: prepare, compute_potential,
    ``steps`` steps, compute_potential, with phase 12's asserts: scatters
    > 0, no bucket read past the grown cap and no clipped level (the
    smoothing-length init's included), |dE/E| < 1e-3, every step's kicks
    conserving momentum, a finite state. Returns (Simulation, seconds of
    the steps)."""
    from sidm_tpu_torch.flagship import SMALL_N, flagship_ics
    from sidm_tpu_torch.simulation import Simulation

    pos, vel, mass = flagship_ics(SMALL_N, SEED)
    sim = Simulation(cfg, mode="synchronized", device=dev)
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(SMALL_N, np.int32))
    assert sim.particles.n_padded == SMALL_N and not sim._use_phased()
    t0 = time.perf_counter()
    sim.prepare()
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    init = dict(sim.last_hsml_init)
    sim.compute_potential()
    e_start = sim_energy(sim)
    scat, drops, walls = [], [], []
    t0 = time.perf_counter()
    for k in range(steps):
        t1 = time.perf_counter()
        _, _, n_scat = sim.step()
        si = dict(sim.last_sidm_info)
        walls.append(time.perf_counter() - t1)
        m = sim.particles.mass[:, None].double()
        kick = si["kick"].double()
        mom = float(torch.linalg.norm(torch.sum(m * kick, 0)))
        scale = float(torch.sum(m * torch.linalg.norm(kick, dim=1,
                                                      keepdim=True)))
        assert mom <= 1e-5 * scale, ("momentum", mom, scale)
        assert si["engine"] == "hash", si["engine"]
        scat.append(n_scat)
        drops.append((si["ngb_ovf"], si["lvl_clip"]))
        wi = sim.last_walk_info
        wovf = (sum(int(wi[f]) for f in ("ovf_open", "ovf_big", "ovf_items"))
                if wi is not None else 0)
        assert wovf == 0, ("walk overflow", wovf)
        print(f"{label} step {k + 1}: wall {walls[-1] * 1e3:.1f} ms ("
              + ", ".join(f"{ph} {s * 1e3:.1f} ms" for ph, s in
                          sim.last_phase_wall.items())
              + f"), scatters {n_scat} of {si['proposals']} proposals, gated "
              f"{si['n_gated']}, cap {si['cap']} (need {si['need']}, passes "
              f"{si['tries']}), buckets past cap {si['ngb_ovf']}, clipped "
              f"levels {si['lvl_clip']}, |sum m dv| {mom:.3e} of sum m|dv| "
              f"{scale:.3e} [{card}]", flush=True)
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    sim.compute_potential()
    torch.cuda.synchronize()
    de = abs(sim_energy(sim) - e_start) / abs(e_start)
    finite = all(bool(torch.isfinite(getattr(sim.particles, f)).all())
                 for f in ("pos", "vel", "hsml_vd", "dvel"))
    print(f"{label} (small-halo, single-program step, ForceMethod "
          f"{cfg.ForceMethod}, walk depth {sim._small_depth or 'default'}): "
          f"N {SMALL_N}, prepare {t_prep:.3f} s (hsml "
          f"init: cap {init['cap']}, need {init['need']}, buckets past cap "
          f"{init['ngb_ovf']}, clipped {init['lvl_clip']}), {steps} steps "
          f"{t_steps:.3f} s, {SMALL_N * steps / t_steps:.1f} "
          f"particle-steps/s, step walls (ms) "
          f"{[round(w * 1e3, 1) for w in walls]}, scatters {scat}, drops "
          f"(buckets, clipped) {drops}, t = {sim.time:.6g}, |dE/E| "
          f"{de:.3e}, finite {finite} [{card}]", flush=True)
    assert finite and de < 1e-3, (finite, de)
    assert sum(scat) > 0, scat
    assert init["ngb_ovf"] == 0 and init["lvl_clip"] == 0, init
    assert all(d == (0, 0) for d in drops), drops
    return sim, t_steps


def small_kernels(res, sim, dev, card):
    """H1, H2 and H3 on small-halo's end state, against their plain
    versions on the next step's inputs: H1 on all N queries (h, counts,
    overflow, need, clip and rows read bit-equal), H2 on the gated targets
    (partners and hits equal except near-ties, counted; need, clip
    equal), H3 on SMALL_TARGETS random targets (p99.9 relative error <
    1e-5 on acc and pot); each timed beside its bound and ptxas's
    registers."""
    from sidm_tpu_torch import integrate
    from sidm_tpu_torch.bounds import (bound_ms, direct_work, knn_work,
                                       scan_work)
    from sidm_tpu_torch.ops.direct import direct_gravity, direct_sum
    from sidm_tpu_torch.ops.neighbors import knn_radius, knn_radius_plain
    from sidm_tpu_torch.ops.sidm import (hash_scan, hash_scan_plain,
                                         sidm_scatter)
    from sidm_tpu_torch.rng import step_key

    p = sim.particles
    cap = sim._hash_cap
    t_next = torch.clamp(integrate.find_next_time(p), max=sim.cfg.TimeMax)
    active = integrate.active_mask(p, t_next)
    pos_pred, _ = integrate.predict_positions(p, t_next, sim.consts)
    vmax = torch.tensor(sim.vmax, dtype=pos_pred.dtype, device=dev)
    key = step_key(sim.root_key, sim.step_count)
    params = sim._sidm_params()
    q, _, info = sidm_scatter(p, pos_pred, t_next, active, vmax, key, params,
                              cap=cap, return_info=True)
    table, n = info["table"], pos_pred.shape[0]
    # H1: the step's hsml refresh on all N queries
    warm = torch.where(p.hsml_vd > 0, p.hsml_vd,
                       2.0 * table.s0).contiguous()
    kargs = (table, pos_pred, p.ptype, warm, params.des_num_ngb)
    kk = knn_radius(*kargs, cap=cap, n_iter=3)
    keys = []
    t0 = time.perf_counter()
    kp = knn_radius_plain(*kargs, cap=cap, n_iter=3, keys=keys)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for f in ("h", "cnt", "ovf", "need", "clip", "scanned"):
        a, b = getattr(kk, f), getattr(kp, f)
        assert torch.equal(a, b.to(a.dtype)), ("hash_knn", f)
    ms = cuda_ms(lambda: knn_radius(*kargs, cap=cap, n_iter=3), 5)
    ops, nb = knn_work(table, keys, kp.scanned, n, cap)
    bms, by = bound_ms(ops, nb)
    rows = kp.scanned.double() / 3.0
    print(f"kernel hash_knn (H1, {n} queries, 3 iterations, cap {cap}, "
          f"k {params.des_num_ngb}): h, counts, overflow, need, clip and "
          f"rows read bit-equal to the plain version; rows read per query "
          f"and iteration mean {float(rows.mean()):.1f}, max "
          f"{float(rows.max()):.0f}; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms (one call), bound {bms:.4f} ms ({by}), at "
          f"{bms / ms:.1%} of the bound's speed; ptxas "
          f"{usage_of('hash_knn_kernel')} [{card}]", flush=True)
    res.add("hash_knn", 0.0, ms, plain_ms, ops, nb)
    # H2: the step's scan on its gated targets
    tid, si = info["tid"], info["scan_inputs"]
    sargs = (table, pos_pred, q.vel.contiguous(), si["hs"].contiguous(),
             q.ptype, si["rand"], si["dts"].contiguous(), tid, t_next,
             si["sigma_co"], params, cap)
    sk = hash_scan(*sargs)
    keys = []
    t0 = time.perf_counter()
    sp = hash_scan_plain(*sargs, keys=keys)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    t = tid.long()
    diff = ((sk.partner != sp.partner) | (sk.hit != sp.hit))[t]
    ties = diff & (sp.margin[t] < TIE)
    assert int(diff.sum()) == int(ties.sum()), ("hash_scan", int(diff.sum()))
    assert torch.equal(sk.need[t], sp.need[t].to(sk.need.dtype))
    assert torch.equal(sk.clip[t], sp.clip[t])
    assert torch.equal(sk.hit, info["scan"].hit)
    ms = cuda_ms(lambda: hash_scan(*sargs), 10)
    ops, nb = scan_work(table, keys, sp.scanned, sp.ok, tid, cap)
    bms, by = bound_ms(ops, nb)
    print(f"kernel hash_scan (H2, {t.numel()} gated targets of {n}, cap "
          f"{cap}): hits {int(sk.hit.sum())}, partners differing "
          f"{int(diff.sum())} (near-ties {int(ties.sum())}), need and clip "
          f"equal; rows read to the crossing {int(sp.scanned[t].sum())}, "
          f"valid pairs {int(sp.ok[t].sum())}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms (one call), bound {bms:.5f} ms ({by}), at "
          f"{bms / ms:.1%} of the bound's speed; ptxas "
          f"{usage_of('hash_scan_kernel')} [{card}]", flush=True)
    res.add("hash_scan", 0.0, ms, plain_ms, ops, nb)
    res.rows["hash_scan"].update(near_ties=int(ties.sum()),
                                 gated=int(t.numel()))
    # H3: the direct sum, all N and SMALL_TARGETS random targets
    eps = sim._softening()[torch.clamp(p.ptype, 0, 5).long()]
    mass = torch.where(p.valid, p.mass, torch.zeros_like(p.mass))
    g = torch.Generator(device="cpu").manual_seed(SEED)
    tg = torch.randperm(int(p.valid.sum()), generator=g)[:SMALL_TARGETS].to(
        dev)
    acc_k, pot_k = direct_sum(pos_pred, mass, eps, targets=tg)
    acc_p, pot_p = direct_gravity(pos_pred, mass, eps, targets=tg)
    e = torch.linalg.norm(acc_k - acc_p, dim=1) / torch.clamp(
        torch.linalg.norm(acc_p, dim=1), min=1e-30)
    ep = torch.abs(pot_k - pot_p) / torch.clamp(torch.abs(pot_p), min=1e-30)
    err = float(torch.max(torch.abs(acc_k - acc_p)))
    ms_t = cuda_ms(lambda: direct_sum(pos_pred, mass, eps, targets=tg), 5)
    plain_t_ms = cuda_ms(lambda: direct_gravity(pos_pred, mass, eps,
                                                targets=tg), 1)
    ms = cuda_ms(lambda: direct_sum(pos_pred, mass, eps,
                                    with_potential=False), 2)
    ms_pot = cuda_ms(lambda: direct_sum(pos_pred, mass, eps), 2)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    direct_gravity(pos_pred, mass, eps, with_potential=False)
    b.record()
    b.synchronize()
    plain_ms = a.elapsed_time(b)       # one call, all N targets
    ops, nb = direct_work(n, n, False)
    bms, by = bound_ms(ops, nb)
    ops_t, nb_t = direct_work(n, SMALL_TARGETS, True)
    print(f"kernel direct (H3, N {n}): {SMALL_TARGETS} random targets vs the "
          f"plain sum: acc p99.9 rel err {q999(e):.3e} (max "
          f"{float(e.max()):.3e}), pot p99.9 {q999(ep):.3e}; all N targets "
          f"{ms:.3f} ms (with the potential {ms_pot:.3f} ms), bound "
          f"{bms:.3f} ms ({by}), at {bms / ms:.1%} of the bound's speed; "
          f"plain {plain_ms:.1f} ms (one call); {SMALL_TARGETS} targets "
          f"kernel {ms_t:.3f} ms, plain {plain_t_ms:.3f} ms, bound "
          f"{bound_ms(ops_t, nb_t)[0]:.4f} ms; "
          f"ptxas {usage_of('direct_kernel')} [{card}]", flush=True)
    assert q999(e) < 1e-5 and q999(ep) < 1e-5, (q999(e), q999(ep))
    res.add("direct", err, ms, plain_ms, ops, nb)
    res.rows["direct"].update(targets_ms=ms_t, targets_plain_ms=plain_t_ms,
                              pot_ms=ms_pot,
                              acc_p999=q999(e), pot_p999=q999(ep))


def hash_rate(dev, card):
    """The hash engine's short rate check on phase 10's box, from
    setup_smoothing_lengths (hard sphere, RATE_PASSES passes): printed,
    not held to the 1 % bar (JAX's hash engine reads 0.928 on a CPU,
    BASELINE.md)."""
    from sidm_tpu_torch import validate_rate as vr
    p0, tree, _ = vr.make_box(BOX_N, dev, hsml="knn")
    r = vr.run_type(p0, tree, 0, "hash", RATE_PASSES, BOX_N)
    print(f"rate (hard sphere, N {BOX_N}, {RATE_PASSES} passes, hash, hsml "
          f"knn): events {r['events']}, expected {r['expected']:.1f}, ratio "
          f"{r['ratio']:.4f} +- {r['err']:.4f} "
          f"({'within' if r['ok'] else 'outside'} max(1 %, 3 sigma); "
          f"printed only), drops {r['drops']}, {r['seconds']:.2f} s "
          f"[{card}]", flush=True)


CLI_STEPS = 6           # phase 11's run(max_steps=...)


def cli_path(pos, vel, mass, n, dev, card, dsmc_times, zero_counts,
             read_counts):
    """Phase 11: bench.py's run (``bench_config()`` with ``ScatterLog 1``)
    through the calls ``cli.main`` makes, from a Gadget IC of the halo
    written by the port's writer, then ``python -m sidm_tpu_torch <param> 1``
    with a ``stop`` file. The cadences come from phase 9's step times (the
    same ICs and timestep criterion): statistics every ~3.5 steps (two in
    the window: t = 0 and the fifth step's start), snapshots every ~5.5
    (one in the window, the next in the resumed step). Returns the path's
    launch counts."""
    import os
    import shutil
    import tempfile
    from sidm_tpu_torch.bench import bench_config
    from sidm_tpu_torch.config import write_parameters_out
    from sidm_tpu_torch.diagnostics import CpuLog
    from sidm_tpu_torch.io.checkpoint import read_restart, read_scatter_log
    from sidm_tpu_torch.io.gadget import (GadgetHeader, Snapshot,
                                          read_snapshot, write_snapshot)
    from sidm_tpu_torch.simulation import Simulation
    from sidm_tpu_torch.state import state_dict

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        out = os.path.join(tmp, "out") + "/"
        ic = os.path.join(tmp, "ic")
        t0 = time.perf_counter()
        write_snapshot(ic, Snapshot(
            header=GadgetHeader(), pos=pos.astype(np.float32),
            vel=vel.astype(np.float32),
            pid=np.arange(1, n + 1, dtype=np.uint32),
            mass=mass.astype(np.float32), ptype=np.ones(n, np.int32)))
        t_ic = time.perf_counter() - t0
        cfg = bench_config().replace(
            ScatterLog=1, OutputDir=out, InitCondFile=ic,
            TimeBetStatistics=0.5 * (dsmc_times[3] + dsmc_times[4]),
            TimeOfFirstSnapshot=0.0,
            TimeBetSnapshot=0.5 * (dsmc_times[5] + dsmc_times[6]),
            ResubmitCommand="none",
            OutputListFilename="none")
        param = write_parameters_out(cfg, tmp)
        os.replace(param, os.path.join(tmp, "param.txt"))
        param = os.path.join(tmp, "param.txt")

        torch.cuda.synchronize()
        zero_counts()
        sim = Simulation.from_parameter_file(param, device=dev)
        sim.load_ic()
        t0 = time.perf_counter()
        sim.prepare()
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t0
        # observers: the state each snapshot writes, each step's scatters
        # and walls
        pred, scats, step_walls, kinds = [], [], [], []
        write_snap, step = sim.write_snapshot_file, sim.step

        def snap_observed(count):
            pred.append((count, *sim._predicted_host_state(),
                         sim.particles.valid.cpu().numpy()))
            return write_snap(count)

        def step_observed(first=False):
            t = time.perf_counter()
            r = step(first)
            step_walls.append(time.perf_counter() - t)
            scats.append(r[2])
            kinds.append((sim.last_list_info or {}).get("kind"))
            return r

        sim.write_snapshot_file, sim.step = snap_observed, step_observed
        t0 = time.perf_counter()
        steps = sim.run(max_steps=CLI_STEPS)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = read_counts()
        sim.close_logs()
        t0 = time.perf_counter()
        sim.write_restart_file()
        t_rst = time.perf_counter() - t0
        written = state_dict(sim.particles)
        back, rv = read_restart(os.path.join(out, "rst_out"), device=dev)
        back = state_dict(back)
        restart_equal = all(np.array_equal(written[k], back[k])
                            for k in written)

        def read(name):
            with open(os.path.join(out, name)) as f:
                return f.read()

        logs = {k: read(k) for k in ("energy_out", "info_out", "cpu_out",
                                     "timings_out")}
        energy = np.array([[float(x) for x in line.split()]
                           for line in logs["energy_out"].splitlines()])
        e_tot = energy[:, 2] + energy[:, 3] + energy[:, 1]
        de = abs(e_tot[-1] - e_tot[0]) / abs(e_tot[0])
        cpu = sim.cpu_log.cpu
        assert list(cpu) == CpuLog.BUCKETS and all(
            len(line.split()) == len(cpu)
            for line in logs["cpu_out"].splitlines()[1::2])
        sct = sorted(f for f in os.listdir(out) if f.startswith("sct_"))
        events = [read_scatter_log(os.path.join(out, f)) for f in sct]
        n_ev = sum(len(e[0]) for e in events)
        ids_ok = all(((e[1] >= 1) & (e[1] <= n) & (e[2] >= 1) & (e[2] <= n)
                      & (e[1] != e[2])).all() for e in events)
        snaps_ok = []
        for count, ppos, pvel, valid in pred:
            name = os.path.join(out, f"snp_{count:03d}")
            for native in (True, False):
                s = read_snapshot(name, use_native=native)
                snaps_ok.append(
                    np.array_equal(s.pos, ppos[valid])
                    and np.array_equal(s.vel, pvel[valid])
                    and np.array_equal(s.pid.astype(np.int64),
                                       np.arange(1, n + 1)))
        rate = n * CLI_STEPS / sum(step_walls)
        print(f"cli path (bench_config, ScatterLog 1): N {n}, IC write "
              f"{t_ic:.3f} s, prepare {t_prep:.3f} s, {steps} steps "
              f"{kinds} {sum(step_walls):.3f} s, "
              f"{rate:.1f} particle-steps/s (steps only; run() wall "
              f"{t_run:.3f} s, {n * CLI_STEPS / t_run:.1f} with its I/O), "
              f"energy_statistics {len(energy)} x (Potential "
              f"{cpu['Potential']:.3f} s + Diagnostic {cpu['Diagnostic']:.3f}"
              f" s in all), snapshot {cpu['Snapshot']:.3f} s "
              f"({len(pred)} written), restart write {t_rst:.3f} s, "
              f"|dE/E| {de:.3e}, scatters {scats} -> {n_ev} records in "
              f"{sct}, CPU log buckets (s) "
              f"{ {k: round(v, 4) for k, v in cpu.items()} } [{card}]",
              flush=True)
        assert steps == CLI_STEPS and len(step_walls) == CLI_STEPS
        assert energy.shape == (2, 24) and np.isfinite(energy).all(), \
            energy.shape
        assert de < 1e-3, de
        assert logs["info_out"].count("Begin Step") == CLI_STEPS
        assert len(logs["cpu_out"].splitlines()) == 2 * CLI_STEPS
        assert len(logs["timings_out"].splitlines()) == 2 * CLI_STEPS
        assert len(pred) == 1 and all(snaps_ok), (len(pred), snaps_ok)
        assert n_ev == sum(scats) and 0 < n_ev and ids_ok, \
            (n_ev, scats)
        assert max(scats) <= 4096
        assert restart_equal and rv["step_count"] == CLI_STEPS
        for key in ("far_level", "far_level_record", "range_walk",
                    "near_level", "far_list", "gather_nodes", "sidm_emit",
                    "sidm_emit_count", "segment_totals", "sidm_gated"):
            assert counts[key] > 0, (key, counts)
        del sim, written, back
        torch.cuda.empty_cache()

        # ---- the same run resumed by the CLI, with a stop file ------------
        open(os.path.join(out, "stop"), "w").close()
        before = {f: open(os.path.join(out, f), "rb").read()
                  for f in os.listdir(out) if f != "rst_out.npz"}
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sidm_tpu_torch", param, "1"], cwd=root,
            env=env, capture_output=True, text=True, timeout=600)
        t_resume = time.perf_counter() - t0
        _, rv2 = read_restart(os.path.join(out, "rst_out"), device="cpu")
        after = set(os.listdir(out))
        info2 = read("info_out")
        new = sorted(after - set(before) - {"rst_out.npz"})
        appended = all(open(os.path.join(out, f), "rb").read()
                       .startswith(b) for f, b in before.items())
        print(f"cli resume (python -m sidm_tpu_torch param 1, stop file): "
              f"exit {proc.returncode}, {t_resume:.2f} s wall (process, "
              f"prepare, one step, restart), step_count {rv2['step_count']}, "
              f"snapshot_count {rv2['snapshot_count']}, new files {new}, "
              f"logs appended {appended}, stdout "
              f"{proc.stdout.strip().splitlines()[-1:]} [{card}]",
              flush=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        assert rv2["step_count"] == CLI_STEPS + 1, rv2
        assert appended and info2.count("Begin Step") == CLI_STEPS + 1
        assert f"Begin Step {CLI_STEPS + 1}," in info2
        assert rv2["snapshot_count"] == 2 and "snp_001" in new, (rv2, new)
        assert all(f in ("snp_001", "sct_002.0") for f in new), new
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


VD_STEPS = 4            # phase 13's flagship-veldisp run, after prepare
VD_IND_STEPS = 6        # ... in mode="individual"
IND_STEPS = 4           # flagship-dsmc and small-halo in mode="individual"
VD_SUBSET = 65536       # H4's random queries against the plain pass


def veldisp_path(pos, vel, mass, n, dev, card):
    """flagship-veldisp (``flagship_config(**VELDISP)``) synchronized
    through Simulation: prepare (its first velocity-dispersion pass from no
    smoothing length, timed, with its rows read a query), compute_potential,
    VD_STEPS steps, compute_potential: no list or walk overflow, no bucket
    read past the grown cap and no clipped level in any pass, |dE/E| <
    1e-3, a finite state. Returns the Simulation."""
    from sidm_tpu_torch.flagship import VELDISP, flagship_config
    from sidm_tpu_torch.simulation import Simulation

    sim = Simulation(flagship_config(**VELDISP), mode="synchronized",
                     device=dev)
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(n, np.int32),
                                  pad_to_multiple=4096)
    assert sim._use_phased()
    t0 = time.perf_counter()
    sim.prepare()
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    vds = [dict(sim.last_veldisp_info)]
    prep_walls = dict(sim.last_phase_wall)
    sim.compute_potential()
    e_start = sim_energy(sim)
    ovf, walls = 0, []
    t0 = time.perf_counter()
    for _ in range(VD_STEPS):
        t1 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        li = dict(sim.last_list_info, wall=wall)
        if li["ovf"] is not None:
            ovf += sum(li["ovf"])
        if sim.last_walk_info is not None:
            ovf += sum(int(sim.last_walk_info[k]) for k in
                       ("ovf_open", "ovf_big", "ovf_items"))
        vds.append(dict(sim.last_veldisp_info))
        walls.append((li, dict(sim.last_phase_wall)))
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    sim.compute_potential()
    torch.cuda.synchronize()
    de = abs(sim_energy(sim) - e_start) / abs(e_start)
    finite = all(bool(torch.isfinite(getattr(sim.particles, f)).all())
                 for f in ("pos", "vel", "hsml_vd", "vel_disp", "dens_vd"))

    def vd_line(v):
        return (f"cap {v['cap']} (need {v['need']}), levels {v['levels']}, "
                f"passes {v['tries']}, rows read a query mean "
                f"{v['rows_mean']:.1f} max {v['rows_max']}, buckets past "
                f"cap {v['ngb_ovf']}, clipped {v['lvl_clip']}")

    print(f"flagship-veldisp prepare: {t_prep:.3f} s ("
          + ", ".join(f"{ph} {s * 1e3:.1f} ms" for ph, s in
                      prep_walls.items())
          + f"); its velocity-dispersion pass from no smoothing length: "
          f"{vd_line(vds[0])} [{card}]", flush=True)
    for k, (li, w) in enumerate(walls):
        print(f"veldisp step {k + 1} ({li['kind']}): wall "
              f"{li['wall'] * 1e3:.1f} ms ("
              + ", ".join(f"{ph} {s * 1e3:.1f} ms" for ph, s in w.items())
              + ")"
              + f"; {vd_line(vds[k + 1])} [{card}]", flush=True)
    p = sim.particles
    v = p.valid
    print(f"veldisp path (flagship-veldisp, ListMode 1, VelDispOn 1, "
          f"criterion 4): N {n}, {VD_STEPS} steps {t_steps:.3f} s, "
          f"{n * VD_STEPS / t_steps:.1f} particle-steps/s, t = "
          f"{sim.time:.6g}, vel_disp median "
          f"{float(torch.median(p.vel_disp[v])):.4g}, dens_vd median "
          f"{float(torch.median(p.dens_vd[v])):.4g}, ngb_vd min/max "
          f"{int(p.ngb_vd[v].min())}/{int(p.ngb_vd[v].max())}, |dE/E| "
          f"{de:.3e}, force overflow {ovf}, finite {finite} [{card}]",
          flush=True)
    assert finite and ovf == 0 and de < 1e-3, (finite, ovf, de)
    assert all(x["ngb_ovf"] == 0 and x["lvl_clip"] == 0 for x in vds), vds
    return sim


def veldisp_kernels(res, sim, dev, card):
    """H4 on flagship-veldisp's end state, the next step's pass: the whole
    pass (H1 and H4) against its plain version (``veldisp_plain``) on
    VD_SUBSET random queries and the 8 that read the most rows (hsml_vd
    and the counts equal, dens_vd and vel_disp p99.9 relative error <
    1e-5); H4 on all the pass's queries timed beside its bound and its
    plain version (one call), with ptxas's registers."""
    from sidm_tpu_torch import integrate
    from sidm_tpu_torch.bounds import bound_ms, veldisp_work
    from sidm_tpu_torch.ops.neighbors import candidate_blocks
    from sidm_tpu_torch.ops.veldisp import (veldisp, veldisp_plain,
                                            veldisp_sums, veldisp_sums_plain)

    p = sim.particles
    cap, levels = sim._hash_cap, sim._vd_levels
    t_next = torch.clamp(integrate.find_next_time(p), max=sim.cfg.TimeMax)
    active = integrate.active_mask(p, t_next)
    pos_pred, vel_pred = integrate.predict_positions(p, t_next, sim.consts)
    kw = dict(des_num_ngb=sim.cfg.DesNumNgb, cap=cap, n_levels=levels)
    q, info = veldisp(p, pos_pred, vel_pred, active, **kw)
    assert int(info["ngb_ovf"]) == 0 and int(info["lvl_clip"]) == 0
    sel, rows = info["sel"], info["rows"]
    g = torch.Generator(device="cpu").manual_seed(SEED)
    pick = torch.randperm(sel.numel(), generator=g)[:VD_SUBSET].to(dev)
    pick = torch.unique(torch.cat([pick, torch.topk(rows, LONGEST).indices]))
    sub = torch.zeros_like(active)
    sub[sel[pick]] = True
    qp, _ = veldisp_plain(p, pos_pred, vel_pred, sub, **kw)
    assert torch.equal(q.hsml_vd[sub], qp.hsml_vd[sub]), "hsml_vd"
    assert torch.equal(q.ngb_vd[sub], qp.ngb_vd[sub]), "ngb_vd"
    errs = {}
    for f in ("dens_vd", "vel_disp"):
        a, b = getattr(q, f)[sub].double(), getattr(qp, f)[sub].double()
        errs[f] = (q999(torch.abs(a - b) / torch.clamp(torch.abs(b),
                                                       min=1e-30)),
                   float(torch.max(torch.abs(a - b))))
    # H4 on all the pass's queries
    args = (info["table"], pos_pred[sel].contiguous(),
            p.ptype[sel].contiguous(), info["knn"].h.contiguous())
    sums = info["sums"]
    ms = cuda_ms(lambda: veldisp_sums(*args, cap=cap), 5)
    t0 = time.perf_counter()
    sp = veldisp_sums_plain(*args, cap=cap)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for f in ("cnt", "need", "scanned"):
        assert torch.equal(getattr(sums, f), getattr(sp, f).to(
            getattr(sums, f).dtype)), f
    keys = []
    candidate_blocks(info["table"], *args[1:], cap=cap, keys=keys)
    ops, nb = veldisp_work(info["table"], keys, sums.scanned, sums.cnt,
                           sel.numel(), cap)
    bms, by = bound_ms(ops, nb)
    knn_rows = info["knn"].scanned.double() / 3.0
    print(f"kernel veldisp (H4, {sel.numel()} queries, cap {cap}, {levels} "
          f"levels): the pass against its plain version on {int(sub.sum())} "
          f"queries (the 8 reading the most rows among them, up to "
          f"{int(rows.max())}): hsml_vd and counts equal, dens_vd p99.9 rel "
          f"err {errs['dens_vd'][0]:.3e}, vel_disp {errs['vel_disp'][0]:.3e};"
          f" all queries: counts, need and rows read equal to the plain sums, "
          f"rows read a query {float(sums.scanned.double().mean()):.1f} (H1 "
          f"a query and iteration {float(knn_rows.mean()):.1f}), neighbours "
          f"a query {float(sums.cnt.double().mean()):.1f}; kernel {ms:.3f} "
          f"ms, plain {plain_ms:.1f} ms (one call), bound {bms:.4f} ms "
          f"({by}), at {bms / ms:.1%} of the bound's speed; ptxas "
          f"{usage_of('hash_veldisp_kernel')} [{card}]", flush=True)
    assert errs["dens_vd"][0] < 1e-5 and errs["vel_disp"][0] < 1e-5, errs
    res.add("veldisp", max(e[1] for e in errs.values()), ms, plain_ms, ops,
            nb)
    res.rows["veldisp"].update(queries=int(sel.numel()),
                               checked=int(sub.sum()),
                               dens_p999=errs["dens_vd"][0],
                               disp_p999=errs["vel_disp"][0])


def predicted_energy(sim) -> float:
    """The energy at the Simulation's time with every particle predicted to
    it (the common time of individual steps): the potential at the
    predicted positions (``compute_potential``) and the predicted
    velocities' kinetic energy, in float64."""
    from sidm_tpu_torch import integrate
    pot = sim.compute_potential()
    p = sim.particles
    t = torch.tensor(sim.time, dtype=p.pos.dtype, device=p.pos.device)
    _, vel_pred = integrate.predict_positions(p, t, sim.consts)
    m = torch.where(p.valid, p.mass, torch.zeros_like(p.mass)).double()
    return float(0.5 * torch.sum(m * torch.sum(vel_pred.double() ** 2, 1))
                 + 0.5 * torch.sum(m * pot.double()))


def individual_run(cfg, pos, vel, mass, n, dev, card, label, steps,
                   pad=4096):
    """``cfg`` in ``mode="individual"`` through Simulation: prepare, then
    ``steps`` steps, each printed with its active particles; asserts that
    after the first step fewer than N are active, that every step leaves
    the inactive particles' pos, vel, current_time, max_pred_time (and
    with VelDispOn the veldisp fields) unchanged bit for bit, that the
    DSMC kicks (if any) conserve momentum with no drop, that |dE/E| at the
    common predicted time stays < 1e-3 and the state finite. Returns the
    per-step rows."""
    from sidm_tpu_torch.simulation import Simulation

    sim = Simulation(cfg, mode="individual", device=dev)
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(n, np.int32),
                                  pad_to_multiple=pad)
    t0 = time.perf_counter()
    sim.prepare()
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    e_start = predicted_energy(sim)
    # the DSMC list cadence clamps every particle's stale smoothing length
    # on its rebuild steps (JAX's simulation.py:1036-1047): hsml_vd is held
    # only with the velocity-dispersion pass
    kept = ("pos", "vel", "current_time", "max_pred_time") + (
        ("hsml_vd", "ngb_vd", "vel_disp", "dens_vd") if cfg.VelDispOn
        else ())
    rows = []
    for k in range(steps):
        p0 = sim.particles
        before = {f: getattr(p0, f).clone() for f in kept}
        t_next = float(torch.min(torch.where(
            p0.valid, p0.max_pred_time,
            torch.full_like(p0.max_pred_time, 1e37))))
        t1 = time.perf_counter()
        _, n_act, n_scat = sim.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        p = sim.particles
        inactive = p.valid & (before["max_pred_time"] > t_next)
        assert int(inactive.sum()) == int(p.valid.sum()) - n_act
        # activation is an equality test: count the inactive particles a
        # last-bit difference in their kick time would have activated
        ties = int(torch.sum(inactive & (before["max_pred_time"] - t_next
                                         <= 1e-6 * abs(t_next))))
        changed = [f for f in kept if not torch.equal(
            getattr(p, f)[inactive], before[f][inactive])]
        assert not changed, (label, k, "inactive particles changed", changed)
        row = dict(n_active=n_act, wall=wall, walls=dict(sim.last_phase_wall),
                   kind=(sim.last_list_info or {}).get("kind", "single"),
                   ties=ties)
        si = sim.last_sidm_info
        if si is not None:
            m = p.mass[:, None].double()
            kick = si["kick"].double()
            mom = float(torch.linalg.norm(torch.sum(m * kick, 0)))
            scale = float(torch.sum(m * torch.linalg.norm(kick, dim=1,
                                                          keepdim=True)))
            assert mom <= 1e-5 * scale, ("momentum", mom, scale)
            # the hash engine's buckets past the cap and clipped levels,
            # the lists' gated/tail and candidate segment drops, the walk's
            drops = [si.get("ngb_ovf", 0), si.get("lvl_clip", 0),
                     *si.get("ovf_g", []), *si.get("cand_ovf", [0])[:1],
                     *si.get("walk_ovf", [])]
            assert not any(drops), (label, k, drops)
            row.update(engine=si["engine"], n_gated=si["n_gated"],
                       n_scat=n_scat, mom=mom, scale=scale)
        if sim.last_veldisp_info is not None:
            vi = sim.last_veldisp_info
            assert vi["ngb_ovf"] == 0 and vi["lvl_clip"] == 0, vi
            assert vi["queries"] == n_act, vi
            row.update(vd_queries=vi["queries"])
        rows.append(row)
        print(f"{label} individual step {k + 1} ({row['kind']}): "
              f"t = {sim.time:.9g}, active {n_act} of {n} (inactive within "
              f"1e-6 of the kick time: {ties}), wall "
              f"{wall * 1e3:.1f} ms ("
              + ", ".join(f"{ph} {s * 1e3:.1f} ms" for ph, s in
                          row["walls"].items()) + ")"
              + (f", gated {row['n_gated']}, scatters {row['n_scat']}, "
                 f"|sum m dv| {row['mom']:.3e} of {row['scale']:.3e}"
                 if "engine" in row else "")
              + f" [{card}]", flush=True)
    de = abs(predicted_energy(sim) - e_start) / abs(e_start)
    finite = all(bool(torch.isfinite(getattr(sim.particles, f)).all())
                 for f in ("pos", "vel", "hsml_vd"))
    nact = [r["n_active"] for r in rows]
    print(f"{label} in mode individual: N {n}, prepare {t_prep:.3f} s, "
          f"{steps} steps, active per step {nact}, the list cadence's skin "
          f"{sim._skin_now:.4g} from the last dt {sim._last_dt:.4g}, |dE/E| "
          f"at the common predicted time {de:.3e}, finite {finite} "
          f"[{card}]", flush=True)
    assert finite and de < 1e-3, (finite, de)
    assert max(nact) < n, nact
    del sim
    return rows


def sim_energy(sim) -> float:
    from sidm_tpu_torch.diagnostics import compute_system_state
    s = compute_system_state(sim.particles)
    return float(s.energy_kin + s.energy_pot)


# ---- phase 14: periodic boxes, TreePM and comoving runs (cosmo-box) --------

COSMO_STEPS = 5        # cosmo-box's phased steps after prepare (a rebuild
                       # at the 4th: TreeRefreshSteps 4)
COSMO_PLAIN_TARGETS = 1024   # H3 periodic against its plain version
PDIRECT_N = 4096       # the small periodic box of ForceMethod direct
PDIRECT_STEPS = 4
LATTICE_M = 64         # JAX's comoving lattice, 64^3 particles
LATTICE_STEPS = 4
COSMO_SIZE = None      # (N, mesh) in place of cosmo-box's (a rehearsal's)


def cosmo_path(dev, card):
    """cosmo-box (``flagship.cosmo_config()``, N = 2^20, mesh 256) through
    Simulation on the phased step: prepare, COSMO_STEPS steps (refreshes and
    a rebuild), with the walls of each step's phases, a, the walk's
    overflow and the positions kept in [0, box). Returns the Simulation."""
    from sidm_tpu_torch.flagship import COSMO_N, cosmo_config, cosmo_ics
    from sidm_tpu_torch.simulation import Simulation

    n, mesh = COSMO_SIZE or (COSMO_N, None)
    cfg = cosmo_config(n, **({"PMGrid": mesh} if mesh else {}))
    pos, vel, mass = cosmo_ics(n, SEED)
    sim = Simulation(cfg, mode="phased", device=dev)
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(n, np.int32))
    t0 = time.perf_counter()
    sim.prepare()
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    a0 = sim.time
    ovf, walls, kinds = 0, [], []
    t0 = time.perf_counter()
    for k in range(COSMO_STEPS):
        t1 = time.perf_counter()
        dt, _, _ = sim.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        wi = sim.last_walk_info
        o = [int(wi[f]) for f in ("ovf_open", "ovf_big", "ovf_items")]
        ovf += sum(o)
        kinds.append("rebuild" if sim.last_step_rebuilt else "refresh")
        print(f"cosmo-box step {k + 1} ({kinds[-1]}): wall "
              f"{walls[-1] * 1e3:.1f} ms ("
              + ", ".join(f"{ph} {v * 1e3:.1f} ms" for ph, v in
                          sim.last_phase_wall.items())
              + f"), a = {sim.time:.7g} (da {dt:.4g}), walk overflow {o}, "
              f"segments {int(wi['n_segs'])} [{card}]", flush=True)
    t_steps = time.perf_counter() - t0
    p = sim.particles
    pv = p.pos[p.valid]
    lo, hi = float(pv.min()), float(pv.max())
    finite = bool(torch.isfinite(p.pos).all() and torch.isfinite(p.vel).all())
    print(f"cosmo-box (periodic comoving TreePM, phased step): N {n}, "
          f"mesh {cfg.PMGrid}, rcut {sim._pm_kernel().rcut:.1f} kpc/h, "
          f"prepare {t_prep:.3f} s, {COSMO_STEPS} steps {t_steps:.3f} s "
          f"({n * COSMO_STEPS / t_steps:.1f} particle-steps/s), kinds "
          f"{kinds}, a {a0:.7g} -> {sim.time:.7g}, positions in "
          f"[{lo:.4f}, {hi:.4f}] of box {cfg.BoxSize}, overflow {ovf}, "
          f"finite {finite} [{card}]", flush=True)
    assert finite and ovf == 0, (finite, ovf)
    assert sim.time > a0, (a0, sim.time)
    assert lo >= 0.0 and hi < cfg.BoxSize, (lo, hi)
    assert "rebuild" in kinds and "refresh" in kinds, kinds
    return sim


def pm_breakdown(sim, card):
    """The mesh solve of one cosmo-box step on its end state, by part
    (CUDA events): the two deposits, the two forward FFTs, the six inverse
    FFTs and the two gathers, beside the whole ``pm_accel``."""
    from sidm_tpu_torch.ops import pm

    kern = sim._pm_kernel()
    p = sim.particles
    box, n = kern.box, kern.n
    h = box / n
    pos = torch.remainder(p.pos, box)
    mass = torch.where(p.valid, p.mass, torch.zeros_like(p.mass))
    pos2 = torch.remainder(pos + 0.5 * h, box)
    dep = cuda_ms(lambda: (pm.cic_deposit(pos, mass, box, n),
                           pm.cic_deposit(pos2, mass, box, n)), 5)
    rho = pm.cic_deposit(pos, mass, box, n)
    fwd = cuda_ms(lambda: (torch.fft.rfftn(rho), torch.fft.rfftn(rho)), 5)
    spec = torch.fft.rfftn(rho)
    inv = cuda_ms(lambda: [torch.fft.irfftn(spec, s=(n, n, n), norm="forward")
                           for _ in range(6)], 5)
    f4 = torch.zeros(n ** 3, 4, device=pos.device)
    gat = cuda_ms(lambda: (pm.cic_gather(f4, pos, box, n),
                           pm.cic_gather(f4, pos2, box, n)), 5)
    whole = cuda_ms(lambda: pm.pm_accel(kern, p.pos, mass), 5)
    print(f"cosmo-box mesh solve (mesh {n}, N {pos.shape[0]}): pm_accel "
          f"{whole:.3f} ms; deposits {dep:.3f} ms, forward FFTs {fwd:.3f} "
          f"ms, inverse FFTs {inv:.3f} ms, gathers {gat:.3f} ms [{card}]",
          flush=True)
    return dict(pm_ms=whole, deposit_ms=dep, fft_ms=fwd + inv, gather_ms=gat)


def scaled_err(a, ref):
    """Per-row |a - ref| / max(|ref|, median |ref|) (rows of vectors or
    scalars): tests/test_pm.py's normalisation, which keeps near-zero
    periodic forces and potentials from dividing by ~0."""
    a, ref = a.double(), ref.double()
    if ref.dim() == 1:
        a, ref = a[:, None], ref[:, None]
    n = torch.linalg.norm(ref, dim=1)
    return torch.linalg.norm(a - ref, dim=1) / torch.clamp(
        n, min=float(torch.quantile(n, 0.5)))


def cosmo_oracle(sim, dev, card):
    """TreePM (the walk's periodic mode on a fresh tree plus the mesh)
    against H3's periodic direct sum with the Ewald tables on
    ORACLE_TARGETS random targets, at tests/test_pm.py's bars with that
    test's opening (geometric, theta 0.5); the run's own criterion
    (relative, ErrTolForceAcc 0.005, with the run's old accelerations) is
    printed beside it. Returns the H3 call's inputs."""
    from sidm_tpu_torch import integrate
    from sidm_tpu_torch.ops.direct import direct_sum

    p, cfg = sim.particles, sim.cfg
    t = torch.tensor(sim.time, dtype=sim.dtype, device=dev)
    pos, _ = integrate.predict_positions(p, t, sim.consts)
    soft = sim._softening()
    eps = soft[torch.clamp(p.ptype, 0, 5).long()]
    mass = torch.where(p.valid, p.mass, torch.zeros_like(p.mass))
    g = torch.Generator().manual_seed(SEED)
    nv = int(p.valid.sum())
    tg = torch.randperm(nv, generator=g)[:ORACLE_TARGETS].to(dev)
    ew = sim._ewald_table()
    t0 = time.perf_counter()
    acc_r, pot_r = direct_sum(pos, mass, eps, targets=tg, box=cfg.BoxSize,
                              ewald=ew)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    outs = {}
    for label, opening in (("theta 0.5 (tests/test_pm.py)", 0),
                           ("the run's relative criterion", 1)):
        sim.cfg = dataclasses.replace(cfg, TypeOfOpeningCriterion=opening,
                                      ErrTolTheta=0.5)
        acc, pot, _ = sim._force(p, pos, soft, True)
        sim.cfg = cfg
        rel = scaled_err(acc[tg], acc_r)
        perr = scaled_err(pot[tg], pot_r)
        m = mass[tg].double()
        e_ref = float(0.5 * torch.sum(m * pot_r.double()))
        e_err = abs(float(0.5 * torch.sum(m * pot[tg].double())) - e_ref) \
            / abs(e_ref)
        out = dict(acc_p99=float(torch.quantile(rel, 0.99)),
                   acc_max=float(rel.max()),
                   pot_p99=float(torch.quantile(perr, 0.99)), energy=e_err)
        outs[label] = out
        print(f"cosmo-box oracle, {label}: TreePM (walk + mesh "
              f"{sim._pm_kernel().n}) vs H3's periodic Ewald direct sum on "
              f"{tg.numel()} targets (H3 call {t_ref:.3f} s): acc p99 "
              f"{out['acc_p99']:.3e} (bar 2.5e-3), max {out['acc_max']:.3e} "
              f"(6e-3), pot p99 {out['pot_p99']:.3e} (8e-3), potential "
              f"energy {out['energy']:.3e} (5e-3) [{card}]", flush=True)
    out = outs["theta 0.5 (tests/test_pm.py)"]
    assert out["acc_p99"] < 2.5e-3 and out["acc_max"] < 6e-3, out
    assert out["pot_p99"] < 8e-3 and out["energy"] < 5e-3, out
    return pos, mass, eps, tg, ew, outs


def same_as_sets(k, p) -> bool:
    """far_level's periodic outputs equal as sets per group (each live
    prefix sorted) and its counts equal."""
    if not torch.equal(k.cnt, p.cnt):
        return False
    for f, row in (("far", 0), ("seg", 1), ("fids", 2), ("bkey", 6)):
        pv = getattr(p, f)
        if pv is None:
            continue
        kv = getattr(k, f)
        live = (torch.arange(pv.shape[1], device=pv.device)[None, :]
                < p.cnt[row][:, None])
        big = torch.iinfo(pv.dtype).max
        if not torch.equal(torch.sort(torch.where(live, kv, big), 1).values,
                           torch.sort(torch.where(live, pv, big), 1).values):
            return False
    return True


def cosmo_kernels(res, sim, oracle_in, dev, card):
    """Each periodic kernel mode against its plain version at cosmo-box's
    shapes: every far_level, far_list and near_level call of one periodic
    walk of the end state (a fresh tree, the run's opening criterion),
    all groups: far_level's lists equal as sets and its counts equal,
    far_list and near_level p99.9 < 2e-5 on acc and pot (with and without
    the potential); each mode's time per walk (CUDA events) beside its
    bound and its plain version's; H3 periodic on COSMO_PLAIN_TARGETS
    targets against the plain periodic direct sum, p99.9 < 1e-5 on acc and
    pot, and its time on ORACLE_TARGETS targets beside its bound."""
    from sidm_tpu_torch import integrate
    from sidm_tpu_torch.bounds import (bound_ms, direct_work, far_level_work,
                                       far_list_work, near_level_work)
    from sidm_tpu_torch.ops.direct import direct_gravity, direct_sum
    from sidm_tpu_torch.ops.far_kernel import far_level, far_level_plain
    from sidm_tpu_torch.ops.far_list import far_list, far_list_plain
    from sidm_tpu_torch.ops.fused_force import default_depth
    from sidm_tpu_torch.ops.near_kernel import near_level, near_level_plain
    from sidm_tpu_torch.ops.tree import build_octree
    from sidm_tpu_torch.ops.wq_force import wq_gravity_tree

    cfg, p = sim.cfg, sim.particles
    pos, mass, eps, tg, ew, _ = oracle_in
    tree = build_octree(pos, mass, eps, p.valid, box=cfg.BoxSize,
                        depth=default_depth(p.n_padded),
                        uniform_eps=sim._check_uniform_eps())
    calls = []
    wq_gravity_tree(tree, mass, eps, p.old_acc, theta=cfg.ErrTolTheta,
                    opening=cfg.TypeOfOpeningCriterion,
                    err_tol_force_acc=cfg.ErrTolForceAcc, need_pot=False,
                    pbc=sim._pbc(),
                    on_level=lambda name, level, kw: calls.append(
                        (name, level, dict(kw))))
    t = {k: dict(ms=0.0, plain_ms=0.0, ops=0.0, bytes=0.0, err=0.0,
                 max_abs=0.0, calls=0)
         for k in ("far_level_periodic", "far_list_periodic",
                   "near_level_periodic")}
    nvalid = None
    for name, level, kw in calls:
        key = name + "_periodic"
        r = t[key]
        r["calls"] += 1
        if name == "far_level":
            k, pl = far_level(**kw), far_level_plain(**kw)
            assert same_as_sets(k, pl), ("far_level periodic", level)
            work = far_level_work(kw, pl.cnt)
            fn, plain = far_level, far_level_plain
        else:
            valid = kw["te"] != 1.0
            nvalid = torch.sum(valid, 1)
            fn, plain = ((far_list, far_list_plain) if name == "far_list"
                         else (near_level, near_level_plain))
            for pot in (False, True):
                pkw = dict(kw, need_pot=pot)
                a, b = fn(**pkw), plain(**pkw)
                assert bool(torch.isfinite(a).all()), (key, level)
                e, ep = rel_err(a, b, valid)
                errs = [q999(e)] + ([q999(ep)] if pot else [])
                r["err"] = max(r["err"], *errs)
                r["max_abs"] = max(r["max_abs"], float(
                    torch.max(torch.abs(a - b)[valid])) if valid.any()
                    else 0.0)
                assert max(errs) < 2e-5, (key, level, pot, errs)
            work = (far_list_work(kw["tbl"], kw["nf"], nvalid,
                                  kw["need_pot"], periodic=True)
                    if name == "far_list" else near_level_work(kw, nvalid))
        r["ms"] += cuda_ms(lambda: fn(**kw), 3)
        r["plain_ms"] += cuda_ms(lambda: plain(**kw), 1)
        r["ops"] += work[0]
        r["bytes"] += work[1]
    for key, r in t.items():
        bms, by = bound_ms(r["ops"], r["bytes"])
        print(f"kernel {key} (one cosmo-box walk, all groups, {r['calls']} "
              f"calls): "
              + ("lists equal as sets, counts equal" if key.startswith(
                  "far_level") else
                 f"p99.9 err {r['err']:.3e} (acc and pot, with and without "
                 f"the potential), max abs {r['max_abs']:.3e}")
              + f"; {r['ms']:.3f} ms per walk (CUDA events), plain "
              f"{r['plain_ms']:.3f} ms, bound {bms:.4f} ms ({by}), at "
              f"{bms / max(r['ms'], 1e-9):.1%} of the bound's speed "
              f"[{card}]", flush=True)
        res.add(key, r["max_abs"], r["ms"], r["plain_ms"], r["ops"],
                r["bytes"])
        res.rows[key].update(p999_err=r["err"])

    # H3 periodic: kernel vs plain on a subset, timed on ORACLE_TARGETS
    box = cfg.BoxSize
    sub = tg[:COSMO_PLAIN_TARGETS]
    errs = []
    for pot in (False, True):
        ak, pk = direct_sum(pos, mass, eps, targets=sub, with_potential=pot,
                            box=box, ewald=ew)
        ap, pp = direct_gravity(pos, mass, eps, targets=sub,
                                with_potential=pot, box=box, ewald=ew)
        errs.append(q999(scaled_err(ak, ap)))
        if pot:
            errs.append(q999(scaled_err(pk, pp)))
        mx = float(torch.max(torch.abs(ak - ap)))
    assert max(errs) < 1e-5, ("direct periodic", errs)
    ms = cuda_ms(lambda: direct_sum(pos, mass, eps, targets=tg, box=box,
                                    ewald=ew), 3)
    plain_ms = cuda_ms(lambda: direct_gravity(pos, mass, eps, targets=sub,
                                              box=box, ewald=ew), 1)
    work = direct_work(int(p.n_padded), tg.numel(), True, en=ew.en)
    bms, by = bound_ms(*work)
    print(f"kernel direct_periodic (H3 periodic, {tg.numel()} targets x "
          f"{p.n_padded} sources, Ewald EN {ew.en}): p99.9 err vs plain on "
          f"{sub.numel()} targets {max(errs):.3e} (acc; acc and pot with the "
          f"potential; each against max(|plain|, median |plain|)), max abs "
          f"{mx:.3e}; {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms on {sub.numel()} targets, bound {bms:.3f} ms "
          f"({by}), at {bms / ms:.1%} of the bound's speed [{card}]",
          flush=True)
    res.add("direct_periodic", mx, ms, plain_ms, *work)
    res.rows["direct_periodic"].update(p999_err=max(errs),
                                       plain_targets=sub.numel())


def periodic_direct_run(dev, card):
    """A small periodic box with ForceMethod direct on the single-program
    step (tests/test_periodic_comoving.py:90-119's run at N = PDIRECT_N):
    prepare, compute_potential, PDIRECT_STEPS steps, compute_potential;
    the energy drift bounded by 0.2 of the kinetic energy (that test's
    bar), positions in [0, box)."""
    from sidm_tpu_torch.config import SimConfig
    from sidm_tpu_torch.diagnostics import compute_system_state
    from sidm_tpu_torch.simulation import Simulation

    rng = np.random.default_rng(6)
    n, box = PDIRECT_N, 10.0
    cfg = SimConfig(
        PeriodicBoundariesOn=1, BoxSize=box, GravityConstantInternal=1.0,
        ForceMethod="direct", TreeWalkEngine="wq", SIDMOn=0,
        TypeOfTimestepCriterion=1, ErrTolVelScale=0.1, MaxSizeTimestep=0.25,
        TimeMax=20.0, SofteningHalo=0.2, SofteningHaloMaxPhys=0.2,
        UnitLength_in_cm=1.0, UnitMass_in_g=1.0, UnitVelocity_in_cm_per_s=1.0)
    sim = Simulation(cfg, mode="synchronized", device=dev)
    sim.set_particles_from_arrays(rng.uniform(0, box, (n, 3)),
                                  rng.normal(0, 0.02, (n, 3)),
                                  np.full(n, 1.0 / n), np.ones(n, np.int32),
                                  pad_to_multiple=n)
    sim.prepare()
    sim.compute_potential()
    s0 = compute_system_state(sim.particles)
    e0, k0 = float(s0.energy_kin + s0.energy_pot), float(s0.energy_kin)
    walls = []
    for _ in range(PDIRECT_STEPS):
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    sim.compute_potential()
    s1 = compute_system_state(sim.particles)
    e1 = float(s1.energy_kin + s1.energy_pot)
    pv = sim.particles.pos
    print(f"periodic box, ForceMethod direct (single-program step): N {n}, "
          f"{PDIRECT_STEPS} steps, walls (ms) "
          f"{[round(w * 1e3, 2) for w in walls]}, t = {sim.time:.5g}, "
          f"|dE| {abs(e1 - e0):.3e} of E_kin {k0:.3e}, positions in "
          f"[{float(pv.min()):.4f}, {float(pv.max()):.4f}] [{card}]",
          flush=True)
    assert abs(e1 - e0) < 0.2 * k0, (e0, e1, k0)
    assert float(pv.min()) >= 0.0 and float(pv.max()) < box


def lattice_run(dev, card):
    """JAX's comoving lattice (tests/test_periodic_comoving.py:56-87) at
    LATTICE_M^3 particles on the phased step (TreePM, the wq walk): a
    advances and every particle stays within 2e-3 box of its site."""
    from sidm_tpu_torch.config import SimConfig
    from sidm_tpu_torch.simulation import Simulation

    m, box = LATTICE_M, 10.0
    n = m ** 3
    g = (np.arange(m) + 0.5) / m * box
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    pos = np.stack([x, y, z], -1).reshape(-1, 3)
    cfg = SimConfig(
        ComovingIntegrationOn=1, PeriodicBoundariesOn=1, BoxSize=box,
        Omega0=1.0, OmegaLambda=0.0, HubbleParam=1.0, TimeBegin=0.02,
        TimeMax=0.05, ForceMethod="tree", TreeWalkEngine="wq", ListMode=0,
        SIDMOn=0, TypeOfTimestepCriterion=0, ErrTolIntAccuracy=0.05,
        MaxSizeTimestep=0.002, SofteningHalo=0.1 * 8 / m,
        SofteningHaloMaxPhys=0.1 * 8 / m, UnitLength_in_cm=3.085678e24,
        UnitMass_in_g=1.989e43, UnitVelocity_in_cm_per_s=1e5)
    sim = Simulation(cfg, mode="phased", device=dev)
    G, H = sim.units.G, sim.units.Hubble
    mass = np.full(n, 3 * H * H / (8 * np.pi * G) * box ** 3 / n)
    sim.set_particles_from_arrays(pos, np.zeros((n, 3)), mass,
                                  np.ones(n, np.int32), pad_to_multiple=n)
    sim.prepare()
    t0 = time.perf_counter()
    for _ in range(LATTICE_STEPS):
        sim.step()
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    d = torch.abs(sim.particles.pos[:n].double()
                  - torch.tensor(pos, device=dev))
    drift = float(torch.minimum(d, box - d).max())
    print(f"comoving lattice (phased step, TreePM mesh "
          f"{sim._pm_kernel().n}): {n} particles, {LATTICE_STEPS} steps "
          f"{t_steps:.3f} s, a 0.02 -> {sim.time:.6g}, largest drift "
          f"{drift:.3e} ({drift / box:.3e} box, bar 2e-3) [{card}]",
          flush=True)
    assert sim.time > 0.02 and drift < 2e-3 * box, (sim.time, drift)


if __name__ == "__main__":
    sys.exit(main())
