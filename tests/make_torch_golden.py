"""Write the JAX reference outputs that the PyTorch port's tests hold it
against. The JAX runs are dominated by XLA compiles on the CPU, over the
per-file budget of the test suite, so their outputs are committed:

* ``tests/data/torch_slice_golden.npz`` (tests/test_torch_slice.py): the
  JAX ``Simulation`` of the first slice (N = 2048 NFW halo, ``SIDMOn 0``,
  ``TreeWalkEngine wq``, ``ListMode 0``, ``TreeRefreshSteps 2``; prepare, 3
  steps, ``compute_potential`` before and after);
* ``tests/data/torch_list_slice_golden.npz``
  (tests/test_torch_list_slice.py): the same halo in the second slice's
  configuration (``ListMode 1``, ``TreeRefreshSteps 4``, ``ListNearCap
  8192``; prepare, 6 steps),
  with the JAX cadence state after every step;
* ``tests/data/torch_list_golden.npz`` (tests/test_torch_list.py): the
  cached-list functions of ``sidm_tpu/ops/list_force.py`` on an
  n = 2500 NFW halo: its tree's moments, lists recorded at skin 0 and 1,
  ``eval_lists`` with ``materialize`` off and on (fresh and after an
  ``advance_tree`` drift), and a record under tiny caps.

* ``tests/data/torch_sidm_golden.npz`` (tests/test_torch_sidm.py,
  tests/test_torch_sidm_lists.py): the DSMC pieces on the same n = 2500
  halo: ``rng.py`` keys, uniforms and directions, ``sigma_v_product`` for
  cross-section types 0-4, ``_mix32``/``_pair_gumbel``,
  ``_resolve_conflicts_compact`` on random proposals with collisions, the
  hsml seed and ``tree_hsml_init_fused``, ``record_candidates`` at skin 0
  and 0.5 and under tiny caps, ``_eval_gated`` (two tiers, and under tiny
  capacities) and ``sidm_scatter_lists`` with the resolver's proposals;
* ``tests/data/torch_sidm_slice_golden.npz``
  (tests/test_torch_sidm_slice.py): the JAX ``Simulation`` of
  flagship-dsmc (``flagship_config(**DSMC)``) at N = 2048, prepare + 6
  steps, with the state, the smoothing lengths and the cadence after every
  step.

* ``tests/data/torch_sidm_walk_golden.npz`` (tests/test_torch_sidm_walk.py,
  tests/test_torch_sidm_walk_slice.py): the DSMC engine on the range walk.
  ``n_*``: ``_sidm_near_tile`` as ``_sidm_near_level`` runs it, on random
  segment lists of a random particle set, for hard-sphere and Yukawa
  cross-sections, the second in a periodic box; ``a_*``:
  ``sidm_scatter_fused`` on a uniform N = 2048 box (the setup of
  tests/test_fused_range.py); ``b_*``: a cluster across the corner of a
  periodic box, with ``tree_hsml_init_fused(box=)``,
  ``record_candidates_from_particles(box=)``, ``_eval_gated(box=)`` and
  ``sidm_scatter_fused(box=)``; ``w{k}_``/``x{k}_``: the JAX
  ``Simulation`` of flagship-dsmc-walk (``ListMode 0``) and of
  flagship-dsmc whose candidate cap refit is exhausted at once, both on
  ``TreeWalkEngine fused`` (JAX's ``wq`` branch raises ``NameError``,
  ROADMAP C.9).

* ``tests/data/torch_run_golden.npz`` (tests/test_torch_run.py): the JAX
  run loop on ``RUN_CONFIG`` (flagship-dsmc as in ``SIDM_SLICE_CONFIG``
  with ``ScatterLog 1`` and statistics and snapshot cadences) from a Gadget
  IC of the N = 2048 halo: ``load_ic``, prepare and ``run(max_steps=6)``
  (``a_``), then a second ``Simulation(restart_flag=1)`` resuming from its
  restart file in the same directory for 3 steps (``b_``); each output
  file's bytes after each run.

* ``tests/data/torch_hash_golden.npz`` (tests/test_torch_neighbors.py,
  tests/test_torch_sidm_hash.py, tests/test_torch_small_slice.py,
  tests/test_torch_rate.py): the hash-grid engine on ``hash_inputs`` (an
  NFW halo of 4000 particles, 50 of type 2, padded to 4096; ``o_``
  open, ``b_`` wrapped into a periodic box): ``build_table`` (its
  non-empty buckets and ``sorted_part``), ``level_for_radius``,
  ``gather_candidates`` at cap 8, ``knn_radius`` at caps 96 and 8 and
  ``setup_smoothing_lengths``; ``sidm_scatter`` on the open halo for
  cross-section types 0-4 (``s{t}_``) with the partners and hits of its
  scan; ``_resolve_conflicts`` on random proposals (``r{k}_``); the JAX
  ``Simulation(mode="synchronized")`` of ``HASH_CONFIG`` at N = 2048 on
  the single-program step, prepare + 4 steps, under ``ForceMethod tree``
  (``t{k}_``) and ``direct`` (``d{k}_``); and the hash engine's events in
  the rate harness's frozen box at N = 4096 (``rate_``).

* ``tests/data/torch_veldisp_golden.npz`` (tests/test_torch_veldisp.py,
  tests/test_torch_individual.py, tests/test_torch_individual_phased.py):
  ``veldisp`` at cap 96 on ``veldisp_inputs`` (``o``: the NFW halo of 4096,
  64 of type 2; ``b``: a uniform periodic box), a cold pass with every
  particle active (``{tag}1_``) and a warm pass from its lengths with half
  of them active (``{tag}2_``); and the JAX ``Simulation`` on the inputs of
  its own tests: ``test_individual_timestep_mode_conserves_energy``
  (``ind``: the state before each of the first IND["steps"] steps and the
  free run's active counts and energies), ``test_veldisp_and_criterion_4``
  (``vd4``), ``test_phased_veldisp_matches_synchronized`` (``pvd``, with
  ``TreeWalkEngine wq``), flagship-veldisp in ``mode="individual"`` on the
  phased step at N = 4096 (``pind``) and a Plummer sphere with the hash
  DSMC engine in ``mode="individual"`` (``hind``, with its scatter log).

* ``tests/data/torch_periodic_golden.npz`` (tests/test_torch_ewald.py,
  tests/test_torch_pm.py, tests/test_torch_periodic_walk.py,
  tests/test_torch_cosmo_slice.py): periodic boxes and TreePM. ``ew_``:
  the unit box's Ewald tables (EN = 64) and lookups in a box of 100;
  ``sr_``: ``short_range_screen``/``_fac``/``_pot``; ``pm_``: on
  tests/test_pm.py's 2048-particle cloud, ``cic_deposit``, ``pm_accel``
  and ``pot_self`` (mesh 64, asmth 2, interlaced; ``pm2_`` mesh 32, asmth
  1.25, not interlaced), the periodic direct sum with the Ewald table
  (``pd_``) and ``wq_gravity(pbc=)`` with geometric and relative opening
  (``tp0_``, ``tp1_``); ``cl_``, ``ft_``, ``nt_``: ``_classify(pbc)``,
  ``_far_tile_pbc`` and ``_near_tile(pbc)`` on random inputs; ``cs{k}_``
  and ``cp{k}_``: the JAX ``Simulation`` of cosmo-box
  (``flagship.COSMO``) at N = 2048 with ``PMGrid 64`` on the
  single-program and the phased step, prepare + PERIODIC["steps"] steps;
  ``lat_``: tests/test_periodic_comoving.py's comoving lattice on
  ``TreeWalkEngine wq``.

Each test file has a ``slow`` test that reruns its JAX outputs and holds the
file to them. Rerun this script to regenerate the files (all, or the ones
named: ``slice``, ``list_slice``, ``list``, ``sidm``, ``sidm_slice``,
``sidm_walk``, ``run``, ``hash``, ``veldisp``, ``periodic``):

    python -m tests.make_torch_golden [slice] [list_slice] [list] [sidm]
        [sidm_slice] [sidm_walk] [run] [hash] [veldisp] [periodic]
"""

import os
import sys
import tempfile

import numpy as np

from sidm_tpu_torch.flagship import (COSMO, DSMC, FLAGSHIP, LISTS, VELDISP,
                                     cosmo_ics, cosmo_softening,
                                     flagship_ics)

N = 2048
STEPS = 3
SEED = 12345
_DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = os.path.join(_DATA, "torch_slice_golden.npz")
LIST_SLICE_GOLDEN = os.path.join(_DATA, "torch_list_slice_golden.npz")
LIST_GOLDEN = os.path.join(_DATA, "torch_list_golden.npz")

# the first slice (sidm_tpu_torch/flagship.py with ListMode 0) with a short
# rebuild cadence, so that the 3 steps include both a rebuild and a refresh
CONFIG = {**FLAGSHIP, "ListMode": 0, "TreeRefreshSteps": 2}

# the second slice (sidm_tpu_torch/flagship.py, ListMode 1, a 4-step
# cadence): prepare records at skin 0 (the first cycle's skin, ROADMAP
# C.2), step 1 evaluates the lists and the validity monitor forces a
# rebuild, step 2 records under a learned skin, steps 3-5 evaluate cached
# lists, step 6 records again
LIST_CONFIG = {**FLAGSHIP, **LISTS}
LIST_STEPS = 6

# tests/test_torch_list.py: the JAX list test's halo (test_list_force.py:19)
LIST_N = 2500
LIST_SEED = 7
LIST_SKINS = (0.0, 1.0)
LIST_DT = 0.02          # advance_tree drift: pos + LIST_DT * vel
TINY_CAPS = dict(far_cap=32, near_cap=32, lvl_cap=32, used_cap=64)

SIDM_GOLDEN = os.path.join(_DATA, "torch_sidm_golden.npz")
SIDM_SLICE_GOLDEN = os.path.join(_DATA, "torch_sidm_slice_golden.npz")
# flagship-dsmc at N = 2048, with CrossSection raised 100x (bench.py:
# 38.2614): at bench.py's value no particle of this small halo scatters in
# the 6 steps; at 100x four of them do. The SIDM timestep criterion caps
# the per-step probability (ProbabilityTol), so a larger CrossSection
# shrinks the step and does not add scatters per step: no conflict between
# two proposals occurs here at any value. The resolver's conflicts are held
# in tests/test_torch_sidm.py (random proposals) and in
# tests/test_torch_sidm_lists.py (a scatter pass with 243 proposals).
SIDM_SLICE_CONFIG = {**FLAGSHIP, **LISTS, **DSMC, "CrossSection": 3826.14}
SIDM_STEPS = 6
SIDM_SEED = (55, 497527)
SIDM_STEP_NUMBERS = (0, 1, 2, 7, 123456, 0x7FFFFFFF)
SIDM_SIGMA = dict(sigma_co=2.5, yukawa_velocity=300.0, vel_scale=100.0,
                  pow_law=-1.5)
SIDM_SKINS = (0.0, 0.5)
SIDM_TINY = dict(k_cap=16, seg_cap=64, lvl_cap=16)
SIDM_SCATTER = dict(sigma=1e4, time=0.05, salt=5, step=3, k_dense=48,
                    n_pending=64)
SIDM_TINY_GATED = dict(ngc=16, ntail=16, kd=48)


def sidm_rng_inputs():
    """(pids uint32, rv float32, (i, j) uint32 pairs, salts) of the RNG
    and cross-section checks."""
    rng = np.random.default_rng(11)
    pid = np.concatenate([np.arange(1, 4097), [0, 2 ** 31, 2 ** 32 - 1]])
    rv = rng.uniform(0.0, 2000.0, 4096).astype(np.float32)
    ij = rng.integers(0, 2 ** 31, (2, 4096)).astype(np.uint32)
    return pid.astype(np.uint32), rv, ij, (0, 5, 2 ** 32 - 1)


def sidm_resolve_inputs():
    """Random proposals with collisions: 3000 particles, 900 proposers,
    partners drawn from 400 particles (so many proposals share one)."""
    rng = np.random.default_rng(12)
    prop = np.full(3000, -1, np.int32)
    who = rng.choice(3000, 900, replace=False)
    prop[who] = rng.integers(0, 400, 900)
    prop[who[:20]] = who[:20]          # self proposals, as JAX takes them
    return prop


def sidm_pending(n):
    """Particles with a kick not yet applied (no partner, no target)."""
    rng = np.random.default_rng(13)
    dvel = np.zeros((n, 3), np.float32)
    dvel[rng.choice(n, SIDM_SCATTER["n_pending"], replace=False)] = 1.0
    return dvel


def snapshot(p, sim, state, prefix, out):
    out[prefix + "time"] = np.float64(sim.time)
    for f in ("pos", "vel", "accel", "max_pred_time", "pot"):
        out[prefix + f] = np.asarray(getattr(p, f))
    out[prefix + "ekin"] = np.float64(np.sum(np.asarray(
        state.energy_kin_comp)))
    out[prefix + "epot"] = np.float64(np.sum(np.asarray(
        state.energy_pot_comp)))


def jax_trajectory() -> dict:
    """The JAX Simulation's snapshots, keyed like the golden file."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sidm_tpu.config import SimConfig
    from sidm_tpu.diagnostics import compute_system_state
    from sidm_tpu.simulation import Simulation

    # the port's ICs are the JAX package's bit for bit
    # (test_torch_foundation.test_ics_copy_equal)
    pos, vel, mass = flagship_ics(N, SEED)
    sim = Simulation(SimConfig(**CONFIG), mode="phased", quiet=True)
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32))
    sim.prepare()
    out = {}
    snapshot(sim.particles, sim, compute_system_state(sim.particles),
             "s0_", out)
    sim.compute_potential()
    snapshot(sim.particles, sim, compute_system_state(sim.particles),
             "p0_", out)
    for k in range(1, STEPS + 1):
        sim.step()
        snapshot(sim.particles, sim, compute_system_state(sim.particles),
                 f"s{k}_", out)
    sim.compute_potential()
    snapshot(sim.particles, sim, compute_system_state(sim.particles),
             f"p{STEPS}_", out)
    return out


def jax_list_trajectory() -> dict:
    """The JAX Simulation in LIST_CONFIG: snapshots as jax_trajectory's,
    plus after every step ``k{k}_`` the cadence state: whether the step
    rebuilt, the skin in force, whether lists are cached, and the DIAG
    interaction counters."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sidm_tpu.config import SimConfig
    from sidm_tpu.diagnostics import compute_system_state
    from sidm_tpu.simulation import Simulation

    pos, vel, mass = flagship_ics(N, SEED)
    sim = Simulation(SimConfig(**LIST_CONFIG), mode="phased", quiet=True)
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32))
    out = {}

    def cadence(prefix):
        out[prefix + "rebuilt"] = np.bool_(sim._last_step_rebuilt)
        out[prefix + "skin"] = np.float64(sim._skin_now)
        out[prefix + "listed"] = np.bool_(sim._lists_cache is not None)
        out[prefix + "diag"] = np.array([sim._diag_far, sim._diag_near],
                                        np.int64)

    sim.prepare()
    cadence("k0_")
    snapshot(sim.particles, sim, compute_system_state(sim.particles),
             "s0_", out)
    for k in range(1, LIST_STEPS + 1):
        sim.step()
        cadence(f"k{k}_")
        snapshot(sim.particles, sim, compute_system_state(sim.particles),
                 f"s{k}_", out)
    sim.compute_potential()
    snapshot(sim.particles, sim, compute_system_state(sim.particles),
             f"p{LIST_STEPS}_", out)
    return out


def list_inputs():
    """(pos, vel, mass, eps, old_acc) float32 of tests/test_torch_list.py:
    the NFW halo and |a| of its float64 direct sum (softened as the tree
    is), so that the relative opening criterion is exercised."""
    from sidm_tpu_torch.io import ics
    pos, vel, mass = ics.nfw(LIST_N, rho0=1.49e-4, rs=11.14356, G=43007.1,
                             seed=LIST_SEED)
    eps = np.full(LIST_N, 0.3)
    d = pos[None, :, :] - pos[:, None, :]
    r = np.sqrt(np.sum(d * d, axis=-1))
    h = 2.8 * eps[0]
    u = r / h
    wf = np.where(u < 0.5, 32.0 * (1 / 3 - 1.2 * u ** 2 + u ** 3),
                  64.0 * (1 / 3 - 0.75 * u + 0.6 * u ** 2 - u ** 3 / 6)
                  - 1 / (15 * np.maximum(u, 1e-12) ** 3)) / h ** 3
    f = np.where(u >= 1, 1 / np.maximum(r, 1e-30) ** 3, wf) * mass[None, :]
    acc = np.sum(f[..., None] * d, axis=1)
    f32 = np.float32
    return (pos.astype(f32), vel.astype(f32), mass.astype(f32),
            eps.astype(f32), np.linalg.norm(acc, axis=1).astype(f32))


def jax_list_ops() -> dict:
    """The JAX cached-list functions on list_inputs(), keyed ``tree_*``
    (the JAX tree's moments), ``s{i}_*`` (lists at LIST_SKINS[i]),
    ``eval_{fresh,adv}_{gather,mat}_{acc,pot}``, ``adv_mac`` and
    ``tiny_*`` (lists under TINY_CAPS)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu.ops import fused_force as ff
    from sidm_tpu.ops import list_force as lf
    from sidm_tpu.ops.tree import build_octree

    pos, vel, mass, eps, old = (jnp.asarray(a) for a in list_inputs())
    valid = jnp.ones(LIST_N, bool)
    tree = build_octree(pos, mass, eps, valid, box=0.0,
                        depth=ff.default_depth(LIST_N))
    out = {"tree_mac_rows": np.asarray(tree.mac_rows),
           "tree_quad_rows": np.asarray(tree.quad_rows)}
    kw = dict(theta=0.5, use_relative=True, err_tol_force_acc=0.005,
              vel=vel, t_now=1.0)

    def record(prefix, lcfg, skin):
        lists = lf.record_lists(tree, old[tree.perm], valid[tree.perm],
                                lcfg=lcfg, skin=skin, **kw)
        for f in lf.InteractionLists._fields:
            if f != "matf":
                out[prefix + f] = np.asarray(getattr(lists, f))
        return lists

    for i, skin in enumerate(LIST_SKINS):
        record(f"s{i}_", lf.ListConfig(), skin)
    record("tiny_", lf.ListConfig(**TINY_CAPS), 0.0)
    # eval on the skin-1 lists, fresh and after a drift of LIST_DT
    t2 = 1.0 + LIST_DT
    pos2 = pos + LIST_DT * vel
    for mode, lcfg in (("gather", lf.ListConfig()),
                       ("mat", lf.ListConfig(materialize=True))):
        lists = lf.record_lists(tree, old[tree.perm], valid[tree.perm],
                                lcfg=lcfg, skin=LIST_SKINS[1], **kw)
        tree2 = lf.advance_tree(tree, lists, pos2, t2)
        out["adv_mac"] = np.asarray(tree2.mac_rows)
        for when, tr, t in (("fresh", tree, 1.0), ("adv", tree2, t2)):
            acc, pot = lf.eval_lists(tr, lists, mass, eps, lcfg=lcfg,
                                     need_pot=True, t_now=t)
            out[f"eval_{when}_{mode}_acc"] = np.asarray(acc)
            out[f"eval_{when}_{mode}_pot"] = np.asarray(pot)
    return out


def jax_sidm_ops() -> dict:
    """The JAX DSMC pieces on list_inputs() (see the module note)."""
    import dataclasses

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu import rng
    from sidm_tpu.ops import fused_range as jfr
    from sidm_tpu.ops import list_range as jlr
    from sidm_tpu.ops import sidm as jsidm
    from sidm_tpu.ops import sidm_tree as jst
    from sidm_tpu.ops.fused_force import default_depth
    from sidm_tpu.ops.tree import build_octree
    from sidm_tpu.sidm_common import sigma_v_product
    from sidm_tpu.state import make_particles

    out = {}
    root = rng.run_key(*SIDM_SEED)
    out["rng_root"] = np.asarray(jax.random.key_data(root))
    out["rng_step_keys"] = np.stack([
        np.asarray(jax.random.key_data(rng.step_key(root, s)))
        for s in SIDM_STEP_NUMBERS])
    pid, rv, ij, salts = sidm_rng_inputs()
    k7 = rng.step_key(root, 7)
    out["rng_uniforms"] = np.asarray(rng.particle_uniforms(
        k7, jnp.asarray(pid), 4))
    out["rng_dirs"] = np.asarray(rng.random_directions(k7, jnp.asarray(pid)))
    sg = SIDM_SIGMA
    for t in range(5):
        out[f"sigv_{t}"] = np.asarray(sigma_v_product(
            jnp.asarray(rv), jnp.float32(1.0), jnp.float32(sg["sigma_co"]),
            t, sg["yukawa_velocity"], sg["vel_scale"], sg["pow_law"], False))
    for s in salts:
        out[f"mix32_{s}"] = np.asarray(jst._mix32(
            jnp.asarray(ij[0]), jnp.asarray(ij[1]), jnp.uint32(s)))
        out[f"gumbel_{s}"] = np.asarray(jst._pair_gumbel(
            jnp.asarray(ij[0]), jnp.asarray(ij[1]), jnp.uint32(s)))
    prop = sidm_resolve_inputs()
    out["resolve_accepted"] = np.asarray(
        jsidm._resolve_conflicts_compact(jnp.asarray(prop), prop.shape[0]))

    pos, vel, mass, eps, _ = list_inputs()
    n = LIST_N
    p = make_particles(pos, vel, mass, np.ones(n, np.int32),
                       pad_to_multiple=n)
    tree = build_octree(p.pos, p.mass, jnp.asarray(eps), p.valid, box=0.0,
                        depth=default_depth(n))
    out["hsml_seed"] = np.asarray(jfr.cell_count_hsml_seed(tree, 30))
    p = jfr.tree_hsml_init_fused(p, tree, 30)
    out["hsml_h"] = np.asarray(p.hsml_vd)
    out["hsml_cnt"] = np.asarray(p.ngb_vd)

    sc = SIDM_SCATTER
    params = jsidm.SidmParams(sc["sigma"], 0, 1.0, 1.0, 0.0, 30, 2, False,
                              0.1, 0.0, 0.0)
    rcfg = jlr.RangeListConfig(k_dense=sc["k_dense"])
    for i, skin in enumerate(SIDM_SKINS):
        c = jlr.record_candidates_from_particles(p, p.pos, tree, skin=skin,
                                                 params=params, rcfg=rcfg)
        for f in ("cand", "ncand", "r_ref", "ovf", "need"):
            out[f"c{i}_{f}"] = np.asarray(getattr(c, f))
    c = jlr.record_candidates_from_particles(
        p, p.pos, tree, skin=0.0, params=params,
        rcfg=jlr.RangeListConfig(**SIDM_TINY))
    for f in ("cand", "ncand", "ovf", "need"):
        out[f"tiny_{f}"] = np.asarray(getattr(c, f))

    # one DSMC pass on the skin-0.5 lists, some particles pending
    cands = jlr.record_candidates_from_particles(
        p, p.pos, tree, skin=SIDM_SKINS[1], params=params, rcfg=rcfg)
    p = dataclasses.replace(p, dvel=jnp.asarray(sidm_pending(n)))
    t = jnp.float32(sc["time"])
    vmax = jnp.sqrt(jnp.max(jnp.sum(p.vel ** 2, -1)))
    key = rng.step_key(root, sc["step"])
    rows, hs, dts, typs, sigma_co, scan, h_eff, p_max, rand = \
        jst._tree_sidm_prep(p, p.pos, tree.perm, t, p.valid, vmax, key,
                            params)
    out["prep_hs"] = np.asarray(hs)
    out["prep_scan"] = np.asarray(scan)
    out["prep_h_eff"] = np.asarray(h_eff)
    out["prep_p_max"] = np.asarray(p_max)
    out["h_eff_all"] = np.asarray(jlr.h_eff_all(p, params))
    ngc = max(4096, -(-int(rcfg.gated_frac * n) // 4096) * 4096)
    ntail = max(4096, -(-int(rcfg.tail_frac * ngc) // 4096) * 4096)
    d = tree.pos_s - cands.pos_ref
    md = jnp.sqrt(jnp.max(jnp.sum(d * d, axis=-1)))
    hs_c = jnp.minimum(hs, jnp.maximum(cands.r_ref - 2.0 * md, 0.0))
    tg = SIDM_TINY_GATED
    for name, caps in (("gated", (ngc, ntail, sc["k_dense"])),
                       ("gtiny", (tg["ngc"], tg["ntail"], tg["kd"]))):
        res = jlr._eval_gated(rows, cands.cand, cands.ncand, hs_c, dts,
                              typs, jnp.uint32(sc["salt"]), t, sigma_co,
                              params, *caps)
        for f, v in zip(("ptot", "cnt", "bestk", "bestj", "ovf2"), res):
            out[f"{name}_{f}"] = np.asarray(v)
    p2, n_scat, viol, ovf_g = jlr.sidm_scatter_lists(
        p, p.pos, tree, cands, t, p.valid, vmax, key, params, rcfg=rcfg,
        salt=sc["salt"])
    out["scat_n"] = np.int64(n_scat)
    out["scat_viol"] = np.float32(viol)
    out["scat_ovf"] = np.asarray(ovf_g)
    for f in ("dvel", "hsml_vd", "ngb_vd"):
        out[f"scat_{f}"] = np.asarray(getattr(p2, f))
    # the proposals _tree_sidm_finish resolves (type 0: no angular
    # rejection), rebuilt from the pass's outputs, and their accepted set
    inv = np.argsort(np.asarray(tree.perm))
    ptot = np.asarray(out["gated_ptot"])[inv]
    bj = np.asarray(out["gated_bestj"])[inv]
    perm = np.asarray(tree.perm)
    partner = np.where(bj >= 0, perm[np.clip(bj, 0, n - 1)], -1)
    pend = np.any(np.asarray(p.dvel) != 0, axis=-1)
    r = np.asarray(rand)
    hit = (~pend & np.asarray(scan) & (r < np.asarray(p_max)) & (r < ptot)
           & (partner >= 0) & ~pend[np.clip(partner, 0, n - 1)])
    prop = np.where(hit, partner, -1).astype(np.int32)
    out["scat_proposal"] = prop
    out["scat_accepted"] = np.asarray(
        jsidm._resolve_conflicts_compact(jnp.asarray(prop), n))
    return out


def jax_sidm_trajectory() -> dict:
    """The JAX Simulation of SIDM_SLICE_CONFIG: snapshots as
    jax_list_trajectory's plus ``hsml_vd``/``ngb_vd``/``dvel``, and after
    every step ``k{k}_``: the step's scatter count, whether it rebuilt,
    the skin, whether force and candidate lists are cached, and the steps
    since the last rebuild."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sidm_tpu.config import SimConfig
    from sidm_tpu.diagnostics import compute_system_state
    from sidm_tpu.simulation import Simulation

    pos, vel, mass = flagship_ics(N, SEED)
    sim = Simulation(SimConfig(**SIDM_SLICE_CONFIG), mode="phased",
                     quiet=True)
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32))
    out = {}

    def state(prefix, n_scat):
        snapshot(sim.particles, sim, compute_system_state(sim.particles),
                 prefix, out)
        for f in ("hsml_vd", "ngb_vd", "dvel"):
            out[prefix + f] = np.asarray(getattr(sim.particles, f))
        k = "k" + prefix[1:]
        out[k + "n_scat"] = np.int64(n_scat)
        out[k + "rebuilt"] = np.bool_(sim._last_step_rebuilt)
        out[k + "skin"] = np.float64(sim._skin_now)
        out[k + "listed"] = np.bool_(sim._lists_cache is not None)
        out[k + "cands"] = np.bool_(sim._sidm_cands is not None)
        out[k + "since"] = np.int64(sim._steps_since_build)

    sim.prepare()
    state("s0_", 0)
    for k in range(1, SIDM_STEPS + 1):
        _, _, n_scat = sim.step()
        state(f"s{k}_", n_scat)
    return out


SIDM_WALK_GOLDEN = os.path.join(_DATA, "torch_sidm_walk_golden.npz")
# the segment pass on random segments (n_*): sources, groups, keys
NEAR = dict(n=2048, groups=12, keys=40, salt=9, time=0.05, box=1.0)
# sidm_scatter_fused on the uniform box of tests/test_fused_range.py (a_*)
WALK_A = dict(n=2048, seed=1, sigma=20.0, time=0.01, vmax=5.0, salt=3)
# ... and on a cluster across the corner of a periodic box (b_*), the
# setup of test_fused_range.py::test_periodic_hsml_counts_exact_min_image
WALK_B = dict(n=2048, seed=3, box=50.0, depth=8, sigma=2000.0, time=0.01,
              vmax=5.0, salt=4, skin=0.5, step=3)
# flagship-dsmc-walk with CrossSection raised as in SIDM_SLICE_CONFIG
SIDM_WALK_CONFIG = {**FLAGSHIP, **DSMC, "ListMode": 0,
                    "CrossSection": 3826.14}
# flagship-dsmc with its first candidate record overflowing tiny caps and
# no refit left: the walk from prepare's step on
SIDM_EXHAUST_CONFIG = SIDM_SLICE_CONFIG
SIDM_EXHAUST_CAPS = dict(k_cap=16, seg_cap=64, lvl_cap=16)
WALK_STEPS = 4


def near_inputs(box: float):
    """Random inputs of the segment pass: (rows (n, 8) sorted [pos3 vel3
    mass aux], keys (ng, L) with live counts nn, slots gt, gv, gh, gdt,
    gty, gidx). Sources of types 1 and 2, some pending; slots of both
    types, some dead; positions in [0, box) (or [0, 1))."""
    rng = np.random.default_rng(21 if box else 20)
    c = NEAR
    n, ng, L = c["n"], c["groups"], c["keys"]
    f32 = np.float32
    pos = rng.uniform(0, box or 1.0, (n, 3))
    rows = np.concatenate([
        pos, rng.normal(0, 1, (n, 3)), rng.uniform(0.5, 1.5, (n, 1)) / n,
        (rng.integers(1, 3, n) + 8 * (rng.random(n) < 0.05))[:, None]],
        axis=1).astype(f32)
    keys = np.full((ng, L), 2147483647, np.int32)
    nn = rng.integers(L // 2, L + 1, ng).astype(np.int32)
    for g in range(ng):
        # the walk's keys cover at most LEAF_CAP = 16 particles (a leaf or
        # a chunk of an overfull cell); JAX's tile reads 32 from the key's
        # 16-aligned start
        st = rng.integers(0, n - 16, nn[g])
        cnt = rng.integers(1, 17, nn[g])
        keys[g, :nn[g]] = st * 32 + cnt
    tid = rng.integers(0, n, (ng, 64))
    dead = rng.random((ng, 64)) < 0.2
    gt = rows[tid, :3] + rng.normal(0, 0.02, (ng, 64, 3)).astype(f32)
    if box:
        gt = np.mod(gt, box).astype(f32)
    gv = np.where(dead[..., None], 0, rows[tid, 3:6]).astype(f32)
    # radii that give each live slot ~20-80 pairs among its segments'
    # ~300 random particles, as the walk's targets have (DesNumNgb ~30):
    # a sum of one pair at r ~ h would show one float32 ULP of r, which
    # XLA and PyTorch may round apart, amplified by 1/(1 - r/h) in W
    gh = np.where(dead, 0, rng.uniform(0.25, 0.4, (ng, 64))).astype(f32)
    gdt = np.where(dead, 0, rng.uniform(0.5, 1.0, (ng, 64))).astype(f32)
    gty = np.where(dead, -9, rng.integers(1, 3, (ng, 64))).astype(np.int32)
    gidx = np.where(dead, -1, tid).astype(np.int32)
    return rows, keys, nn, gt.astype(f32), gv, gh, gdt, gty, gidx


def near_params(cs_type: int):
    """(SidmParams fields, sigma_co) of the segment pass checks."""
    return (dict(cross_section_internal=1e3, cross_section_type=cs_type,
                 yukawa_velocity=0.7, cross_section_vel_scale=1.0,
                 cross_section_pow_law=0.0, des_num_ngb=30,
                 max_num_ngb_dev=2, comoving=False, hubble=0.1, omega0=0.0,
                 omega_lambda=0.0), 1e3)


def walk_a_inputs():
    """(pos, vel, mass) of WALK_A (tests/test_fused_range.py:_setup)."""
    rng = np.random.default_rng(WALK_A["seed"])
    n = WALK_A["n"]
    return (rng.uniform(0, 1, (n, 3)), rng.normal(0, 1, (n, 3)),
            np.full(n, 1.0 / n))


def walk_b_inputs():
    """(pos, vel, mass) of WALK_B: a Gaussian cluster (sigma 3) wrapped
    around the corner of the box."""
    rng = np.random.default_rng(WALK_B["seed"])
    n, box = WALK_B["n"], WALK_B["box"]
    pos = (rng.standard_normal((n, 3)) * 3.0) % box
    return pos, rng.normal(0, 1, (n, 3)), np.full(n, 1.0 / n)


def jax_sidm_walk_ops() -> dict:
    """The JAX walk engine's pieces (see the module note)."""
    import dataclasses

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu import rng
    from sidm_tpu.ops import fused_range as jfr
    from sidm_tpu.ops import list_range as jlr
    from sidm_tpu.ops import sidm_tree as jst
    from sidm_tpu.ops.fused_force import FusedConfig
    from sidm_tpu.ops.neighbors import setup_smoothing_lengths
    from sidm_tpu.ops.sidm import SidmParams
    from sidm_tpu.ops.tree import build_octree
    from sidm_tpu.state import make_particles

    out = {}
    # the segment pass on random segments, one group per block
    cfg = FusedConfig()
    for name, cs_type, box in (("n0_", 0, 0.0), ("n2_", 2, NEAR["box"])):
        rows, keys, nn, gt, gv, gh, gdt, gty, gidx = near_inputs(box)
        fields, sco = near_params(cs_type)
        params = SidmParams(**fields)
        n, ng = rows.shape[0], keys.shape[0]
        W = -(-keys.shape[1] // cfg.sc) * cfg.sc
        seg = np.full((ng, W), 2147483647, np.int32)
        seg[:, :keys.shape[1]] = keys
        np16 = -(-n // 16)
        planes = np.zeros((8, np16 * 16), np.float32)
        planes[:, :n] = rows.T
        rows16 = planes.reshape(8, np16, 16).transpose(1, 0, 2).reshape(
            np16, 128)
        rt = jfr.RangeTree(levels=(), rows16=jnp.asarray(rows16),
                           n_levels=())
        state = (jnp.zeros((ng, 64), jnp.float32),
                 jnp.zeros((ng, 64), jnp.int32),
                 jnp.full((ng, 64), -jnp.inf, jnp.float32),
                 jnp.full((ng, 64), -1, jnp.int32))

        def blk(x):
            return jnp.asarray(x).reshape((ng, 1) + x.shape[1:])

        res = jfr._sidm_near_level(
            state, jnp.asarray(seg), jnp.asarray(nn), rt, blk(gt), blk(gv),
            blk(gh), blk(gdt), blk(gty), blk(gidx),
            jnp.uint32(NEAR["salt"]), jnp.float32(NEAR["time"]),
            jnp.float32(sco), params, cfg, ng, 1, box)
        for f, v in zip(("ptot", "ncnt", "bestk", "bestj"), res):
            out[name + f] = np.asarray(v)

    # sidm_scatter_fused on the uniform box
    a = WALK_A
    pos, vel, mass = walk_a_inputs()
    n = a["n"]
    p = make_particles(pos, vel, mass, np.ones(n, np.int32),
                       pad_to_multiple=n)
    p = setup_smoothing_lengths(p, 30, 2)
    out["a_hsml"] = np.asarray(p.hsml_vd)
    params = SidmParams(a["sigma"], 0, 1.0, 1.0, 0.0, 30, 2, False, 0.1,
                        0.0, 0.0, maintenance_rate=1.0)
    tree = build_octree(p.pos, p.mass, jnp.full(n, 0.01, jnp.float32),
                        p.valid)
    q, ns, info = jfr.sidm_scatter_fused(
        p, p.pos, tree, jnp.float32(a["time"]), p.valid,
        jnp.float32(a["vmax"]), rng.run_key(5, 5), params, salt=a["salt"],
        return_info=True)
    out["a_n_scat"] = np.int64(ns)
    for f in ("dvel", "hsml_vd", "ngb_vd"):
        out["a_" + f] = np.asarray(getattr(q, f))
    out["a_ovf"] = np.array([int(info["ovf_open"]), int(info["ovf_big"])])
    out["a_ngb_total"] = np.int64(info["ngb_total"])

    # the periodic cluster: hsml init, candidates, gated tile, walk
    b = WALK_B
    box = b["box"]
    pos, vel, mass = walk_b_inputs()
    n = b["n"]
    p = make_particles(pos, vel, mass, np.ones(n, np.int32),
                       pad_to_multiple=n)
    tree = build_octree(p.pos, p.mass, jnp.full(n, 0.1, jnp.float32),
                        p.valid, box=box, depth=b["depth"])
    out["b_perm"] = np.asarray(tree.perm)
    p = jfr.tree_hsml_init_fused(p, tree, 30, box=box)
    out["b_hsml"] = np.asarray(p.hsml_vd)
    out["b_ngb"] = np.asarray(p.ngb_vd)
    params = SidmParams(b["sigma"], 0, 1.0, 1.0, 0.0, 30, 2, False, 0.1,
                        0.0, 0.0, maintenance_rate=1.0)
    rcfg = jlr.RangeListConfig(k_dense=48)
    c = jlr.record_candidates_from_particles(
        p, p.pos, tree, skin=b["skin"], params=params, box=box, rcfg=rcfg)
    for f in ("cand", "ncand", "r_ref", "ovf", "need"):
        out["b_c_" + f] = np.asarray(getattr(c, f))
    t = jnp.float32(b["time"])
    vmax = jnp.float32(b["vmax"])
    key = rng.step_key(rng.run_key(*SIDM_SEED), b["step"])
    pp = dataclasses.replace(p, dvel=jnp.asarray(sidm_pending(n)))
    rows, hs, dts, typs, sigma_co, *_ = jst._tree_sidm_prep(
        pp, pp.pos, tree.perm, t, pp.valid, vmax, key, params)
    ngc = max(4096, -(-int(rcfg.gated_frac * n) // 4096) * 4096)
    ntail = max(4096, -(-int(rcfg.tail_frac * ngc) // 4096) * 4096)
    hs_c = jnp.minimum(hs, c.r_ref)
    res = jlr._eval_gated(rows, c.cand, c.ncand, hs_c, dts, typs,
                          jnp.uint32(b["salt"]), t, sigma_co, params, ngc,
                          ntail, 48, box)
    for f, v in zip(("ptot", "cnt", "bestk", "bestj", "ovf2"), res):
        out["b_g_" + f] = np.asarray(v)
    q, ns, info = jfr.sidm_scatter_fused(
        pp, pp.pos, tree, t, pp.valid, vmax, key, params, salt=b["salt"],
        box=box, return_info=True)
    out["b_n_scat"] = np.int64(ns)
    for f in ("dvel", "hsml_vd", "ngb_vd"):
        out["b_" + f] = np.asarray(getattr(q, f))
    out["b_ovf"] = np.array([int(info["ovf_open"]), int(info["ovf_big"])])
    return out


def jax_sidm_walk_trajectories() -> dict:
    """The JAX Simulation of SIDM_WALK_CONFIG (``w{k}_``) and of
    SIDM_EXHAUST_CONFIG with the refit exhausted (``x{k}_``), both on
    ``TreeWalkEngine fused``: prepare + WALK_STEPS steps, snapshots as
    jax_sidm_trajectory's (``hsml_vd``, ``ngb_vd``, ``dvel`` and the step's
    scatter count)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sidm_tpu.config import SimConfig
    from sidm_tpu.diagnostics import compute_system_state
    from sidm_tpu.ops.list_range import RangeListConfig
    from sidm_tpu.simulation import Simulation

    pos, vel, mass = flagship_ics(N, SEED)
    out = {}
    for tag, cfg in (("w", SIDM_WALK_CONFIG), ("x", SIDM_EXHAUST_CONFIG)):
        sim = Simulation(SimConfig(**{**cfg, "TreeWalkEngine": "fused"}),
                         mode="phased", quiet=True)
        sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32))
        if tag == "x":
            sim._sidm_rcfg = RangeListConfig(**SIDM_EXHAUST_CAPS)
            sim._sidm_resizes = 3          # no refit left

        def state(k, n_scat):
            prefix = f"{tag}{k}_"
            snapshot(sim.particles, sim,
                     compute_system_state(sim.particles), prefix, out)
            for f in ("hsml_vd", "ngb_vd", "dvel"):
                out[prefix + f] = np.asarray(getattr(sim.particles, f))
            out[prefix + "n_scat"] = np.int64(n_scat)

        sim.prepare()
        state(0, 0)
        if tag == "x":
            out["x_disabled"] = np.bool_(sim._sidm_lists_disabled)
        for k in range(1, WALK_STEPS + 1):
            _, _, n_scat = sim.step()
            state(k, n_scat)
    return out


def jax_sidm_walk() -> dict:
    return {**jax_sidm_walk_ops(), **jax_sidm_walk_trajectories()}


RUN_GOLDEN = os.path.join(_DATA, "torch_run_golden.npz")
# two statistics (t = 0 and t = 0.00082) and two snapshots (t = 0 and
# t = 0.00115) in the first 6 steps; the resume's 3 steps take a third
# statistics and snapshot
RUN_CONFIG = {**SIDM_SLICE_CONFIG, "ScatterLog": 1,
              "TimeBetStatistics": 0.0008, "TimeBetSnapshot": 0.001,
              "TimeOfFirstSnapshot": 0.0, "ResubmitCommand": "none",
              "OutputListFilename": "none"}
RUN_STEPS = 6
RESUME_STEPS = 3


def run_ic(snapshot_cls, header_cls, n: int = N):
    """The Gadget IC of the n-particle halo, as a package's ``Snapshot``."""
    pos, vel, mass = flagship_ics(n, SEED)
    return snapshot_cls(header=header_cls(), pos=pos.astype(np.float32),
                        vel=vel.astype(np.float32),
                        pid=np.arange(1, n + 1, dtype=np.uint32),
                        mass=mass.astype(np.float32),
                        ptype=np.ones(n, np.int32))


def output_files(d: str, tag: str) -> dict:
    """Every file of output directory ``d`` as uint8 bytes, keyed
    ``<tag>file_<name>``."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[f"{tag}file_{name}"] = np.frombuffer(f.read(), np.uint8)
    return out


def jax_run() -> dict:
    """The JAX run loop on RUN_CONFIG: ``ic`` (the IC file's bytes), the
    output files after ``run(max_steps=RUN_STEPS)`` (``a_``) and after the
    resume's RESUME_STEPS steps (``b_``)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sidm_tpu.config import SimConfig
    from sidm_tpu.io.gadget import GadgetHeader, Snapshot, write_snapshot
    from sidm_tpu.simulation import Simulation

    with tempfile.TemporaryDirectory() as tmp:
        ic = os.path.join(tmp, "ic")
        write_snapshot(ic, run_ic(Snapshot, GadgetHeader))
        out_dir = os.path.join(tmp, "out") + "/"
        cfg = SimConfig(**{**RUN_CONFIG, "OutputDir": out_dir,
                           "InitCondFile": ic})
        with open(ic, "rb") as f:
            out = {"ic": np.frombuffer(f.read(), np.uint8)}
        sim = Simulation(cfg, mode="phased", quiet=True)
        sim.load_ic()
        sim.prepare()
        sim.run(max_steps=RUN_STEPS)
        out.update(output_files(out_dir, "a_"))
        sim = Simulation(cfg, restart_flag=1, mode="phased", quiet=True)
        sim.load_restart_file()
        sim.prepare()
        sim.run(max_steps=RUN_STEPS + RESUME_STEPS)
        out.update(output_files(out_dir, "b_"))
    return out


HASH_GOLDEN = os.path.join(_DATA, "torch_hash_golden.npz")
# the hash engine's inputs: 4000 NFW particles (50 of type 2) padded to
# 4096; the periodic variant wraps them into a box of HASH["box"]
HASH = dict(n=4000, npad=4096, n_type2=50, box=300.0, k=30, levels=12,
            small_cap=8, subset=512, seed=5)
# sidm_scatter's pass: time, pending kicks, step key
HASH_SCATTER = dict(sigma=1e4, time=0.05, step=3, n_pending=64)
HASH_RESOLVE = (5, 17, 23)            # random proposal sets' seeds
# the single-program step: flagship-dsmc's SIDM settings with CrossSection
# raised as in SIDM_SLICE_CONFIG (N = 2048 scatters then)
HASH_CONFIG = {**FLAGSHIP, **DSMC, "CrossSection": 3826.14}
HASH_STEPS = 4
# the rate harness's box (validate_rate.py): N, measured passes, type
HASH_RATE = dict(n=4096, passes=8, cs_type=0)


def hash_inputs(box: float):
    """(pos (npad, 3) float32, ptype (npad,) int32) of the hash checks."""
    pos, _, _ = flagship_ics(HASH["n"], SEED)
    if box:
        pos = np.mod(pos, box)
    out = np.zeros((HASH["npad"], 3), np.float32)
    out[:HASH["n"]] = pos
    ptype = np.full(HASH["npad"], -1, np.int32)
    ptype[:HASH["n"]] = 1
    ptype[:HASH["n_type2"]] = 2
    return out, ptype


def hash_radii(n: int):
    """Random query radii spanning the grid's levels."""
    rng = np.random.default_rng(HASH["seed"])
    return np.exp(rng.uniform(np.log(0.5), np.log(3000.0), n)).astype(
        np.float32)


def hash_particles(make_particles, n: int = HASH["n"]):
    """The N-particle halo as a package's padded Particles (all type 1)."""
    pos, vel, mass = flagship_ics(n, SEED)
    return make_particles(pos, vel, mass, np.ones(n, np.int32))


def hash_pending(n):
    """Particles with a kick not yet applied (no partner, no target)."""
    rng = np.random.default_rng(14)
    dvel = np.zeros((n, 3), np.float32)
    dvel[rng.choice(n, HASH_SCATTER["n_pending"], replace=False)] = 1.0
    return dvel


def hash_proposals(seed):
    """Random proposals with collisions (self proposals removed, as JAX's
    test_conflict_resolver_compact_equivalence draws them)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(64, 2048))
    prop = np.full(n, -1, np.int32)
    k = int(rng.integers(0, n // 2))
    who = rng.choice(n, size=k, replace=False)
    prop[who] = rng.integers(0, n, size=k)
    prop[prop == np.arange(n)] = -1
    return prop


def _jax_hash_scan(p, pos_pred, time, active, vmax, key, params):
    """The partners and hits of JAX's ``sidm_scatter`` scan (sidm.py:
    140-256, transcribed with the JAX package's own functions): (partner,
    hit, gate)."""
    import jax.numpy as jnp
    from sidm_tpu.constants import SCAT_KERNEL_FACTOR
    from sidm_tpu.cosmo import drift_factor
    from sidm_tpu.kernels import sph_kernel
    from sidm_tpu.ops.neighbors import (build_table, gather_candidates,
                                        make_payload, payload_flag)
    from sidm_tpu.ops.sidm import update_hsml
    from sidm_tpu.rng import particle_uniforms
    from sidm_tpu.sidm_common import (cross_section_co, sidm_cmax,
                                      sigma_v_product)

    ext = (jnp.max(jnp.where(p.valid[:, None], pos_pred, -jnp.inf), axis=0)
           - jnp.min(jnp.where(p.valid[:, None], pos_pred, jnp.inf), axis=0))
    vol = jnp.prod(jnp.maximum(ext, 1e-10))
    n_valid = jnp.maximum(jnp.sum(p.valid), 1)
    r_k = (3.0 * params.des_num_ngb * vol
           / (4.0 * jnp.pi * n_valid)) ** (1.0 / 3.0)
    hpos = jnp.where(p.hsml_vd > 0, p.hsml_vd, jnp.inf)
    hmin = jnp.min(jnp.where(p.is_collisionless, hpos, jnp.inf))
    s0 = jnp.where(jnp.isfinite(hmin), jnp.maximum(hmin, 1e-12), r_k / 2.0)
    has_pending = jnp.any(p.dvel != 0.0, axis=-1)
    payload = make_payload(pos_pred, p.vel, p.mass, p.ptype, flag=has_pending)
    table = build_table(pos_pred, p.ptype, p.valid, s0=s0,
                        n_levels=params.n_levels, payload=payload)
    p = update_hsml(p, pos_pred, table, active, params)
    dt = 2.0 * (time - p.current_time)
    s_inv = drift_factor(time, params.hubble, params.omega0,
                         params.omega_lambda, params.comoving)
    dt_h0 = jnp.where(active, dt, 0.0) * s_inv
    sigma_co = cross_section_co(time, params.cross_section_internal,
                                params.cross_section_type, params.comoving)
    c_pmax = sidm_cmax(
        time, vmax, params.cross_section_internal, params.cross_section_type,
        params.yukawa_velocity, params.cross_section_vel_scale,
        params.des_num_ngb, params.max_num_ngb_dev, params.hubble,
        params.omega0, params.omega_lambda, params.comoving, per_dt_h0=True)
    eligible = (active & p.is_collisionless & p.valid & (~has_pending)
                & (dt_h0 > 0))
    rand = particle_uniforms(key, p.pid, 3)[:, 0].astype(pos_pred.dtype)
    h_scat = SCAT_KERNEL_FACTOR * p.hsml_vd
    hinv3 = jnp.where(h_scat > 0, 1.0 / jnp.maximum(h_scat, 1e-30) ** 3, 0.0)
    gate = eligible & (c_pmax * p.mass * hinv3 * dt_h0 >= rand)
    idx_all = jnp.arange(pos_pred.shape[0], dtype=jnp.int32)
    tq = np.nonzero(np.asarray(gate))[0]
    idx, rows, mask, _ = gather_candidates(
        table, pos_pred[tq], p.ptype[tq], h_scat[tq], cap=params.cap)
    bpos, bh = pos_pred[tq], h_scat[tq]
    d = rows[..., 0:3] - bpos[:, None, :]
    r = jnp.sqrt(jnp.sum(d * d, axis=-1))
    ok = (mask & (r < bh[:, None]) & (idx != idx_all[tq][:, None])
          & (~payload_flag(rows)))
    wk = sph_kernel(r / bh[:, None]) / (bh[:, None] ** 3)
    rv_vec = p.vel[tq][:, None, :] - rows[..., 3:6]
    rv = jnp.sqrt(jnp.sum(rv_vec * rv_vec, axis=-1))
    sv = sigma_v_product(rv, time, sigma_co, params.cross_section_type,
                         params.yukawa_velocity,
                         params.cross_section_vel_scale,
                         params.cross_section_pow_law, params.comoving)
    prob = jnp.where(ok, 0.5 * rows[..., 6] * wk * sv * dt_h0[tq][:, None],
                     0.0)
    crossed = jnp.cumsum(prob, axis=1) >= rand[tq][:, None]
    any_cross = np.asarray(jnp.any(crossed, axis=1))
    first = jnp.argmax(crossed, axis=1)
    pt = np.asarray(jnp.take_along_axis(idx, first[:, None], axis=1)[:, 0])
    partner = np.full(pos_pred.shape[0], -1, np.int32)
    hit = np.zeros(pos_pred.shape[0], bool)
    partner[tq] = np.where(any_cross, pt, -1)
    hit[tq] = any_cross
    return partner, hit, np.asarray(gate)


def jax_hash_ops() -> dict:
    """The JAX hash engine's pieces (see the module note): tables, levels,
    candidates, radii, sidm_scatter and the resolver."""
    import dataclasses

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu.ops import neighbors as jn
    from sidm_tpu.ops import sidm as js
    from sidm_tpu.rng import run_key, step_key
    from sidm_tpu.state import make_particles

    out = {}
    npad, sub = HASH["npad"], HASH["subset"]
    for tag, box in (("o", 0.0), ("b", HASH["box"])):
        pos, ptype = hash_inputs(box)
        valid = ptype >= 0
        s0 = jn.default_cell_size(pos, valid, HASH["k"], box)
        t = jn.build_table(jnp.asarray(pos), jnp.asarray(ptype),
                           jnp.asarray(valid), s0=s0, box=box,
                           n_levels=HASH["levels"])
        cnt = np.asarray(t.bucket_count)
        nz = np.nonzero(cnt)[0]
        out[f"{tag}_s0"] = np.float64(s0)
        out[f"{tag}_nzkey"] = nz.astype(np.int32)
        out[f"{tag}_nzcount"] = cnt[nz]
        out[f"{tag}_nzstart"] = np.asarray(t.bucket_start)[nz]
        out[f"{tag}_sorted_part"] = np.asarray(t.sorted_part)
        h = hash_radii(npad)
        out[f"{tag}_lev"] = np.asarray(jn.level_for_radius(t, jnp.asarray(h)))
        sel = np.linspace(0, npad - 1, sub).astype(np.int64)
        idx, _, mask, ovf = jn.gather_candidates(
            t, jnp.asarray(pos[sel]), jnp.asarray(ptype[sel]),
            jnp.asarray(h[sel] / 20.0), cap=HASH["small_cap"])
        out[f"{tag}_gidx"] = np.asarray(idx)
        out[f"{tag}_gmask"] = np.asarray(mask)
        out[f"{tag}_govf"] = np.asarray(ovf)
        h0 = jnp.full((npad,), 2.0 * s0, jnp.float32)
        for ctag, cap in (("k", 96), ("k8", HASH["small_cap"])):
            kh, kc, ko = jn.knn_radius(t, jnp.asarray(pos), jnp.asarray(ptype),
                                       h0, HASH["k"], cap=cap, n_iter=3)
            out[f"{tag}_{ctag}h"] = np.asarray(kh)
            out[f"{tag}_{ctag}cnt"] = np.asarray(kc)
            out[f"{tag}_{ctag}ovf"] = np.asarray(ko)
        p = make_particles(pos[:HASH["n"]], np.zeros((HASH["n"], 3)),
                           np.ones(HASH["n"]), ptype[:HASH["n"]],
                           pad_to_multiple=npad)
        p = jn.setup_smoothing_lengths(p, HASH["k"], 2,
                                       box=box if box else None)
        out[f"{tag}_sh"] = np.asarray(p.hsml_vd)
        out[f"{tag}_sn"] = np.asarray(p.ngb_vd)

    # sidm_scatter for the five cross-section types on the open halo
    sc = HASH_SCATTER
    p = hash_particles(make_particles)
    p = jn.setup_smoothing_lengths(p, HASH["k"], 2)
    p = dataclasses.replace(p, dvel=jnp.asarray(hash_pending(
        p.pos.shape[0])))
    vmax = jnp.sqrt(jnp.max(jnp.sum(p.vel ** 2, -1)))
    t_now = jnp.float32(sc["time"])
    active = p.valid
    key = step_key(run_key(55, 497527), sc["step"])
    for cs in range(5):
        params = js.SidmParams(sc["sigma"], cs, 300.0, 100.0, -1.5,
                               HASH["k"], 2, False, 0.1, 0.0, 0.0)
        q, ns = js.sidm_scatter(p, p.pos, t_now, active, vmax, key, params)
        out[f"s{cs}_dvel"] = np.asarray(q.dvel)
        out[f"s{cs}_hsml"] = np.asarray(q.hsml_vd)
        out[f"s{cs}_ngb"] = np.asarray(q.ngb_vd)
        out[f"s{cs}_nscat"] = np.int64(ns)
        partner, hit, gate = _jax_hash_scan(p, p.pos, t_now, active, vmax,
                                            key, params)
        out[f"s{cs}_partner"] = partner
        out[f"s{cs}_hit"] = hit
        out[f"s{cs}_gate"] = gate
    for k, seed in enumerate(HASH_RESOLVE):
        prop = hash_proposals(seed)
        out[f"r{k}_acc"] = np.asarray(js._resolve_conflicts(
            jnp.asarray(prop), prop.shape[0]))
    return out


def jax_hash_trajectories() -> dict:
    """The JAX Simulation of HASH_CONFIG on the single-program step
    (``mode="synchronized"``, N = 2048 < PHASE_THRESHOLD), prepare +
    HASH_STEPS steps under ForceMethod tree (``t{k}_``) and direct
    (``d{k}_``), and the potential after them (``{f}p_pot``)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sidm_tpu.config import SimConfig
    from sidm_tpu.diagnostics import compute_system_state
    from sidm_tpu.simulation import Simulation

    out = {}
    pos, vel, mass = flagship_ics(N, SEED)
    for tag, fm in (("t", "tree"), ("d", "direct")):
        sim = Simulation(SimConfig(**{**HASH_CONFIG, "ForceMethod": fm}),
                         mode="synchronized", quiet=True)
        sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32))
        sim.prepare()

        def state(k, n_scat):
            prefix = f"{tag}{k}_"
            snapshot(sim.particles, sim, compute_system_state(sim.particles),
                     prefix, out)
            for f in ("hsml_vd", "ngb_vd", "dvel"):
                out[prefix + f] = np.asarray(getattr(sim.particles, f))
            out[prefix + "n_scat"] = np.int64(n_scat)

        state(0, 0)
        for k in range(1, HASH_STEPS + 1):
            _, _, n_scat = sim.step()
            state(k, n_scat)
        out[f"{tag}p_pot"] = np.asarray(sim.compute_potential())
    return out


def jax_hash_rate() -> dict:
    """The hash engine in the rate harness's frozen box (JAX's
    scripts/validate_rate.py setup, engine ``sidm_scatter``): the smoothing
    lengths from ``setup_smoothing_lengths``, three converging passes, then
    HASH_RATE["passes"] measured passes' events (``rate_events``)."""
    import dataclasses

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu.ops.neighbors import setup_smoothing_lengths
    from sidm_tpu.ops.sidm import SidmParams, sidm_scatter
    from sidm_tpu.rng import run_key, step_key
    from sidm_tpu.state import make_particles
    from sidm_tpu_torch import validate_rate as vr

    n, cs = HASH_RATE["n"], HASH_RATE["cs_type"]
    rng = np.random.default_rng(vr.SEED)
    pos = rng.uniform(0, vr.BOX, (n, 3))
    vel = rng.normal(0, vr.S_VEL, (n, 3))
    p = make_particles(pos, vel, np.full(n, 1.0 / n), np.ones(n, np.int32),
                       pad_to_multiple=4096)
    p = setup_smoothing_lengths(p, vr.DES_NGB, 2, box=vr.BOX, chunk=2048)
    params = SidmParams(
        cross_section_internal=1.0, cross_section_type=cs,
        yukawa_velocity=vr.VC, cross_section_vel_scale=vr.VSCALE,
        cross_section_pow_law=vr.ALPHA, des_num_ngb=vr.DES_NGB,
        max_num_ngb_dev=2, comoving=False, hubble=1.0, omega0=0.0,
        omega_lambda=0.0)
    vmax = jnp.sqrt(jnp.max(jnp.sum(p.vel ** 2, -1)))
    active = p.valid
    run = jax.jit(lambda p, key, tm: sidm_scatter(p, p.pos, tm, active, vmax,
                                                  key, params, box=vr.BOX))
    for i in range(3):
        q, _ = run(p, run_key(1, i), jnp.float32(1.0))
        p = dataclasses.replace(p, hsml_vd=q.hsml_vd, ngb_vd=q.ngb_vd)
    out = {"rate_hsml": np.asarray(p.hsml_vd)}
    dt = vr.EVENT_FRACTION / vr.analytic_sigma_v(cs, 1.0)
    p = dataclasses.replace(p, current_time=jnp.full_like(p.current_time,
                                                          1.0 - dt / 2))
    ev = [int(run(p, step_key(run_key(7, cs), i), jnp.float32(1.0))[1])
          for i in range(HASH_RATE["passes"])]
    out["rate_events"] = np.asarray(ev, np.int64)
    return out


def jax_hash() -> dict:
    return {**jax_hash_ops(), **jax_hash_trajectories(), **jax_hash_rate()}


VELDISP_GOLDEN = os.path.join(_DATA, "torch_veldisp_golden.npz")
# the velocity-dispersion op's inputs: 4096 particles (the first 64 of type
# 2), DesNumNgb 30; the second pass drifts the positions by drift x vel and
# adds dv-scaled noise to the velocities, half of the particles active
VD = dict(n=4096, n_type2=64, k=30, box=10.0, drift=0.002, dv=0.05, seed=21)
VD_TAGS = {"o": 0.0, "b": VD["box"]}
VD_FIELDS = ("hsml_vd", "ngb_vd", "dens_vd", "vel_disp")
# JAX's tests/test_simulation_features.py:_halo_cfg, on the wq walk (the
# port's only one; the direct sum ignores it)
HALO_CONFIG = dict(
    GravityConstantInternal=1.0, ForceMethod="direct",
    TypeOfTimestepCriterion=1, ErrTolVelScale=0.05, MaxSizeTimestep=0.05,
    TimeBegin=0.0, TimeMax=1.0, SofteningHalo=0.05,
    SofteningHaloMaxPhys=0.05, UnitLength_in_cm=1.0, UnitMass_in_g=1.0,
    UnitVelocity_in_cm_per_s=1.0, SIDMOn=0, DesNumNgb=16,
    MaxNumNgbDeviation=2, TreeWalkEngine="wq")
# test_individual_timestep_mode_conserves_energy: its loop runs until
# t_end or max_steps; the state before each of the first ``steps`` steps
IND_CONFIG = {**HALO_CONFIG, "TimeMax": 1.5, "ErrTolVelScale": 0.04}
IND = dict(n=192, seed=11, pad=64, steps=40, max_steps=200, t_end=1.0)
IND_FIELDS = ("pos", "vel", "accel", "old_acc", "current_time",
              "max_pred_time")
# test_veldisp_and_criterion_4
VD4_CONFIG = {**HALO_CONFIG, "VelDispOn": 1, "TypeOfTimestepCriterion": 4,
              "ErrTolIntAccuracy": 0.2, "TimeMax": 0.5}
VD4 = dict(n=256, seed=23, pad=256, steps=3)
TRAJ_FIELDS = ("pos", "vel", "max_pred_time", "hsml_vd", "ngb_vd",
               "dens_vd", "vel_disp")
# test_phased_veldisp_matches_synchronized
PVD_CONFIG = dict(
    GravityConstantInternal=1.0, UnitLength_in_cm=1.0, UnitMass_in_g=1.0,
    UnitVelocity_in_cm_per_s=1.0, ForceMethod="tree", VelDispOn=1,
    TypeOfTimestepCriterion=2, ErrTolDynamicalAccuracy=0.02,
    ErrTolVelScale=10.0, MaxSizeTimestep=0.01, TimeBegin=0.0, TimeMax=0.03,
    SofteningHalo=0.05, SofteningHaloMaxPhys=0.05, DesNumNgb=16,
    MaxNumNgbDeviation=2, TreeWalkEngine="wq")
PVD = dict(n=1024, seed=3, pad=256, steps=3)
PVD_MODES = {"s": "synchronized", "p": "phased"}
# flagship-veldisp in mode "individual" on the phased step
PIND_CONFIG = {**FLAGSHIP, **LISTS, **VELDISP}
PIND = dict(n=4096, steps=6)
# the hash DSMC engine in mode "individual": a Plummer sphere whose
# particles mostly reach MaxSizeTimestep, so that from step 12 on one
# particle and the other 511 take turns (the 511 scatter)
HIND_CONFIG = {**HALO_CONFIG, "SIDMOn": 1, "CrossSection": 30.0,
               "ProbabilityTol": 0.2, "MaxSizeTimestep": 0.0065,
               "ScatterLog": 1, "RandomSeed1": 7, "RandomSeed2": 77}
HIND = dict(n=512, seed=13, steps=24)
HIND_FIELDS = ("pos", "vel", "dvel", "hsml_vd", "max_pred_time")


def veldisp_inputs(make_particles, box: float):
    """(particles, (pos, vel) of the second pass, its active mask as numpy)
    of the velocity-dispersion op: the NFW halo, or with a box uniform
    positions in it, both with the halo's velocities."""
    n = VD["n"]
    pos, vel, mass = flagship_ics(n, SEED)
    rng = np.random.default_rng(VD["seed"])
    if box:
        pos = rng.uniform(0.0, box, (n, 3))
        mass = np.full(n, 1.0 / n)
    ptype = np.ones(n, np.int32)
    ptype[:VD["n_type2"]] = 2
    p = make_particles(pos, vel, mass, ptype, pad_to_multiple=n)
    pos2 = (pos + VD["drift"] * vel).astype(np.float32)
    vel2 = (vel * (1.0 + VD["dv"] * rng.standard_normal((n, 3)))).astype(
        np.float32)
    active = rng.random(n) < 0.5
    return p, pos2, vel2, active


def plummer(ics, n: int, seed: int):
    """(pos, vel, mass, ptype) of JAX's tests' Plummer spheres."""
    pos, vel, mass = ics.plummer(n, seed=seed)
    return pos, vel, mass, np.ones(n, np.int32)


def jax_veldisp_ops() -> dict:
    """JAX's ``veldisp`` on veldisp_inputs: a cold pass, all active
    (``{tag}1_``), then from its particles a warm pass at the drifted
    positions with half active (``{tag}2_``)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu.ops.veldisp import veldisp
    from sidm_tpu.state import make_particles

    out = {}
    for tag, box in VD_TAGS.items():
        p, pos2, vel2, active = veldisp_inputs(make_particles, box)
        q = veldisp(p, p.pos, p.vel, p.valid, des_num_ngb=VD["k"], box=box)
        q2 = veldisp(q, jnp.asarray(pos2), jnp.asarray(vel2),
                     jnp.asarray(active) & q.valid, des_num_ngb=VD["k"],
                     box=box)
        for stage, r in ((1, q), (2, q2)):
            for f in VD_FIELDS:
                out[f"{tag}{stage}_{f}"] = np.asarray(getattr(r, f))
    return out


def jax_individual_runs() -> dict:
    """The JAX Simulation on the inputs of its own tests and on
    flagship-veldisp (see the module note)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sidm_tpu.config import SimConfig
    from sidm_tpu.diagnostics import compute_system_state
    from sidm_tpu.io import ics
    from sidm_tpu.simulation import Simulation

    def energy(sim):
        s = compute_system_state(sim.particles)
        return float(s.energy_kin + s.energy_pot)

    def fields(sim, prefix, names):
        for f in names:
            out[prefix + f] = np.asarray(getattr(sim.particles, f))
        out[prefix + "time"] = np.float64(sim.time)

    out = {}
    # ind: test_individual_timestep_mode_conserves_energy
    sim = Simulation(SimConfig(**IND_CONFIG), mode="individual", quiet=True)
    sim.set_particles_from_arrays(*plummer(ics, IND["n"], IND["seed"]),
                                  pad_to_multiple=IND["pad"])
    sim.prepare()
    sim.compute_potential()
    out["ind_e0"] = np.float64(energy(sim))
    nact = []
    for k in range(IND["max_steps"]):
        if sim.time >= IND["t_end"]:
            break
        if k <= IND["steps"]:
            fields(sim, f"ind{k}_", IND_FIELDS)
        nact.append(sim.step()[1])
    sim.compute_potential()
    out["ind_e1"] = np.float64(energy(sim))
    out["ind_nact"] = np.asarray(nact, np.int64)
    out["ind_time"] = np.float64(sim.time)
    # vd4: test_veldisp_and_criterion_4
    sim = Simulation(SimConfig(**VD4_CONFIG), mode="synchronized",
                     quiet=True)
    sim.set_particles_from_arrays(*plummer(ics, VD4["n"], VD4["seed"]),
                                  pad_to_multiple=VD4["pad"])
    sim.prepare()
    fields(sim, "vd4_0_", TRAJ_FIELDS)
    for k in range(1, VD4["steps"] + 1):
        sim.step()
        fields(sim, f"vd4_{k}_", TRAJ_FIELDS)
    # pvd: test_phased_veldisp_matches_synchronized
    for tag, mode in PVD_MODES.items():
        sim = Simulation(SimConfig(**PVD_CONFIG), mode=mode, quiet=True)
        sim.set_particles_from_arrays(*plummer(ics, PVD["n"], PVD["seed"]),
                                      pad_to_multiple=PVD["pad"])
        sim.prepare()
        for k in range(PVD["steps"]):
            sim.step()
        fields(sim, f"pvd_{tag}_", TRAJ_FIELDS)
    # pind: flagship-veldisp, individual steps on the phased step
    pos, vel, mass = flagship_ics(PIND["n"], SEED)
    sim = Simulation(SimConfig(**PIND_CONFIG), mode="individual", quiet=True)
    sim.PHASE_THRESHOLD = 0
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(PIND["n"],
                                                          np.int32))
    sim.prepare()
    out["pind0_max_pred_time"] = np.asarray(sim.particles.max_pred_time)
    for k in range(1, PIND["steps"] + 1):
        out[f"pind{k}_nact"] = np.int64(sim.step()[1])
        out[f"pind{k}_max_pred_time"] = np.asarray(
            sim.particles.max_pred_time)
        out[f"pind{k}_time"] = np.float64(sim.time)
    fields(sim, "pind_", TRAJ_FIELDS + ("current_time",))
    # hind: the hash DSMC engine, individual steps, with the scatter log
    with tempfile.TemporaryDirectory() as d:
        sim = Simulation(SimConfig(**HIND_CONFIG, OutputDir=d),
                         mode="individual", quiet=True)
        sim.set_particles_from_arrays(*plummer(ics, HIND["n"], HIND["seed"]),
                                      pad_to_multiple=HIND["n"])
        sim.prepare()
        for k in range(1, HIND["steps"] + 1):
            _, n_act, n_scat = sim.step()
            out[f"hind{k}_nact"] = np.int64(n_act)
            out[f"hind{k}_n_scat"] = np.int64(n_scat)
            fields(sim, f"hind{k}_", HIND_FIELDS)
        out["hind_sct"] = np.fromfile(os.path.join(d, "sct_000.0"),
                                      np.float32).reshape(-1, 20)
    return out


def jax_veldisp() -> dict:
    return {**jax_veldisp_ops(), **jax_individual_runs()}


PERIODIC_GOLDEN = os.path.join(_DATA, "torch_periodic_golden.npz")
# tests/test_pm.py's cloud and split
PM_CLOUD = dict(n=2048, box=100.0, eps=0.15, seed=7, mesh=64, asmth=2.0,
                rcut_fac=6.0)
PM2 = dict(mesh=32, asmth=1.25, rcut_fac=4.5, interlace=False)
SR = dict(alpha=0.32, h=2.8 * 0.15, n=400)
# cosmo-box at N = 2048 (flagship.cosmo_config), mesh 64
PERIODIC = dict(n=2048, seed=3, mesh=64, steps=4)
TILE = dict(seed=11, groups=8, wc=128, g=64, sc=16, npart=600, box=50.0,
            alpha=0.08, rcut=30.0)


def pm_cloud():
    """tests/test_pm.py's clustered cloud: (pos, mass, eps) float32."""
    c = PM_CLOUD
    rng = np.random.default_rng(c["seed"])
    n, box = c["n"], c["box"]
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    pos[:n // 2] = (50.0 + rng.standard_normal((n // 2, 3)) * 4.0) % box
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return pos, mass, np.full(n, c["eps"], np.float32)


def periodic_config(**changes) -> dict:
    """cosmo-box's parameters at PERIODIC["n"] with mesh PERIODIC["mesh"]
    (as ``flagship.cosmo_config``)."""
    eps, cap = cosmo_softening(PERIODIC["n"])
    return {**COSMO, "SofteningHalo": eps, "SofteningHaloMaxPhys": cap,
            "PMGrid": PERIODIC["mesh"], **changes}


def tile_inputs():
    """Random inputs of the periodic tiles (numpy): node rows in the
    pack_tree layout (com, mass, count, node_start, child_start,
    child_count, quadrupole, eps, bmax^2), their raw traces, group boxes
    (the last group dead, parked as the walk parks it), targets, and
    segment keys over a particle set with its planar-by-16 pack."""
    t = TILE
    rng = np.random.default_rng(t["seed"])
    B, WC, G, box = t["groups"], t["wc"], t["g"], t["box"]
    rows = np.zeros((B, WC, 16), np.float32)
    rows[..., 0:3] = rng.uniform(0, box, (B, WC, 3))
    rows[..., 3] = rng.uniform(0.5, 2.0, (B, WC))
    rows[..., 4] = rng.integers(0, 40, (B, WC))
    rows[..., 5] = rng.integers(0, 1000, (B, WC))
    rows[..., 6] = rng.integers(0, 500, (B, WC))
    rows[..., 7] = rng.integers(1, 9, (B, WC))
    rows[..., 8:14] = rng.normal(0, 0.3, (B, WC, 6))
    rows[..., 14] = rng.uniform(0.05, 0.3, (B, WC))
    rows[..., 15] = rng.uniform(0.0, 6.0, (B, WC)) ** 2
    trq = rng.uniform(0.0, 1.0, (B, WC)).astype(np.float32)
    ctr = rng.uniform(0, box, (B, 3))
    half = rng.uniform(0.5, 4.0, (B, 3))
    glo = (ctr - half).astype(np.float32)
    ghi = (ctr + half).astype(np.float32)
    glo[-1], ghi[-1] = 1e18, -1e18
    oac = rng.uniform(0.0, 2e-3, B).astype(np.float32)
    oac[::3] = 0.0
    xr = (ctr[:, None, :] + rng.uniform(-1, 1, (B, G, 3))
          * half[:, None, :]).astype(np.float32) % box
    te = rng.uniform(0.05, 0.3, (B, G)).astype(np.float32)
    n = t["npart"]
    ppos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    ppos[: n // 2] = (ctr[0] + rng.normal(0, 1.0, (n // 2, 3))) % box
    pmass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    peps = rng.uniform(0.05, 0.3, n).astype(np.float32)
    # keys as the walk makes them: a leaf or a chunk of at most 16
    start = rng.integers(0, n - 16, (B, t["sc"]))
    cnt = rng.integers(1, 17, (B, t["sc"]))
    ent = (start * 32 + cnt).astype(np.int32)
    ent[:, -3:] = 2147483647
    return dict(rows=rows, trq=trq, glo=glo, ghi=ghi, oac=oac, xr=xr, te=te,
                ppos=ppos, pmass=pmass, peps=peps, ent=ent,
                s_l=np.float32(8.0))


def part16(pos, mass, eps):
    """JAX's planar-by-16 particle rows (fused_force.pack_part16)."""
    n = pos.shape[0]
    np16 = -(-n // 16)

    def plane(v):
        return np.concatenate([v, np.zeros(np16 * 16 - n, np.float32)]) \
            .reshape(np16, 16)
    return np.concatenate([plane(pos[:, 0]), plane(pos[:, 1]),
                           plane(pos[:, 2]), plane(mass), plane(eps),
                           np.zeros((np16, 48), np.float32)], axis=1)


def jax_periodic() -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu.config import SimConfig
    from sidm_tpu.diagnostics import compute_system_state
    from sidm_tpu.ops import pm
    from sidm_tpu.ops.direct import direct_gravity
    from sidm_tpu.ops.ewald import build_ewald_table
    from sidm_tpu.ops.fused_force import (_classify, _far_tile_pbc,
                                          _near_tile)
    from sidm_tpu.ops.wq_force import wq_gravity
    from sidm_tpu.simulation import Simulation

    out = {}
    c = PM_CLOUD
    with tempfile.TemporaryDirectory() as d:
        unit = build_ewald_table(1.0, en=64, cache_dir=d)
        tab = build_ewald_table(c["box"], en=64, cache_dir=d)
    out["ew_fcorr"] = np.asarray(unit.fcorr)
    out["ew_potcorr"] = np.asarray(unit.potcorr)
    rng = np.random.default_rng(5)
    dd = rng.uniform(-0.5, 0.5, (500, 3)).astype(np.float32) * c["box"]
    dd[:3] = 0.0
    dd[3, :] = [0.5 * c["box"], 0.0, -0.0]
    out["ew_d"] = dd
    out["ew_fc"] = np.asarray(tab.force_correction(jnp.asarray(dd)))
    out["ew_pc"] = np.asarray(tab.pot_correction(jnp.asarray(dd)))

    r = np.linspace(1e-4, 2.0, SR["n"]).astype(np.float32) / SR["alpha"]
    rj, hj = jnp.asarray(r), jnp.asarray(SR["h"], jnp.float32)
    out["sr_r"] = r
    out["sr_screen"] = np.asarray(pm.short_range_screen(rj, SR["alpha"]))
    out["sr_fac"] = np.asarray(pm.short_range_fac(rj, hj, SR["alpha"]))
    out["sr_pot"] = np.asarray(pm.short_range_pot(rj, hj, SR["alpha"]))

    pos, mass, eps = pm_cloud()
    pj, mj, ej = jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(eps)
    out["pm_rho"] = np.asarray(pm.cic_deposit(pj, mj, c["box"], c["mesh"]))
    kern = pm.build_pm_kernel(c["box"], n=c["mesh"], asmth=c["asmth"],
                              rcut_fac=c["rcut_fac"])
    a, p = pm.pm_accel(kern, pj, mj, with_potential=True)
    out.update(pm_acc=np.asarray(a), pm_pot=np.asarray(p),
               pm_pot_self=np.float64(kern.pot_self),
               pm_alpha=np.float64(kern.alpha), pm_rcut=np.float64(kern.rcut))
    kern2 = pm.build_pm_kernel(c["box"], n=PM2["mesh"], asmth=PM2["asmth"],
                               rcut_fac=PM2["rcut_fac"],
                               interlace=PM2["interlace"])
    a, p = pm.pm_accel(kern2, pj, mj, with_potential=True)
    out.update(pm2_acc=np.asarray(a), pm2_pot=np.asarray(p),
               pm2_pot_self=np.float64(kern2.pot_self))
    a, p = direct_gravity(pj, mj, ej, box=c["box"], ewald=tab)
    out.update(pd_acc=np.asarray(a), pd_pot=np.asarray(p))
    pbc = (c["box"], kern.alpha, kern.rcut)
    oa = np.random.default_rng(8).uniform(0.5, 2.0, c["n"]).astype(
        np.float32)
    for opening in (0, 1):
        old = oa if opening else np.zeros(c["n"], np.float32)
        a, p, info = wq_gravity(pj, mj, ej, jnp.asarray(old), theta=0.5,
                                opening=opening, pbc=pbc, return_info=True)
        out[f"tp{opening}_acc"] = np.asarray(a)
        out[f"tp{opening}_pot"] = np.asarray(p)
        out[f"tp{opening}_old"] = old
        for k in ("n_segs", "ovf_open", "ovf_big"):
            out[f"tp{opening}_{k}"] = np.int64(info[k])

    t = tile_inputs()
    tpbc = (TILE["box"], TILE["alpha"], TILE["rcut"])
    for last in (False, True):
        for rel in (False, True):
            planes = _classify(jnp.asarray(t["rows"]), jnp.asarray(t["glo"]),
                               jnp.asarray(t["ghi"]), jnp.asarray(t["oac"]),
                               jnp.asarray(t["s_l"]), 0.25, rel, 16, last,
                               tpbc)
            for name, pl in zip(("far", "seg", "opn", "big"), planes):
                out[f"cl{int(last)}{int(rel)}_{name}"] = np.asarray(pl)
    far = np.asarray(_classify(jnp.asarray(t["rows"]), jnp.asarray(t["glo"]),
                               jnp.asarray(t["ghi"]), jnp.asarray(t["oac"]),
                               jnp.asarray(t["s_l"]), 0.25, False, 16, False,
                               tpbc)[0])
    rows_far = t["rows"].copy()
    rows_far[..., 3] = np.where(far, rows_far[..., 3], 0.0)
    trr = np.where(far, t["trq"], 0.0).astype(np.float32)
    for pot in (False, True):
        da, dp = _far_tile_pbc(jnp.asarray(rows_far), jnp.asarray(trr),
                               jnp.asarray(t["xr"]), jnp.asarray(t["te"]),
                               tpbc, pot)
        out[f"ft{int(pot)}_acc"] = np.asarray(da)
        out[f"ft{int(pot)}_pot"] = np.asarray(dp)
    out["ft_far"] = far
    p16 = jnp.asarray(part16(t["ppos"], t["pmass"], t["peps"]))
    for pot in (False, True):
        da, dp = _near_tile(jnp.asarray(t["ent"]), p16, jnp.asarray(t["xr"]),
                            jnp.asarray(t["te"]), pot, tpbc)
        out[f"nt{int(pot)}_acc"] = np.asarray(da)
        out[f"nt{int(pot)}_pot"] = np.asarray(dp)

    cpos, cvel, cmass = cosmo_ics(PERIODIC["n"], PERIODIC["seed"])
    for tag, mode in (("cs", "synchronized"), ("cp", "phased")):
        with tempfile.TemporaryDirectory() as d:
            sim = Simulation(SimConfig(**periodic_config(OutputDir=d)),
                             mode=mode, quiet=True)
            sim.set_particles_from_arrays(cpos, cvel, cmass,
                                          np.ones(PERIODIC["n"], np.int32))
            sim.prepare()
            snapshot(sim.particles, sim,
                     compute_system_state(sim.particles), f"{tag}0_", out)
            for k in range(1, PERIODIC["steps"] + 1):
                sim.step()
                snapshot(sim.particles, sim,
                         compute_system_state(sim.particles), f"{tag}{k}_",
                         out)
            sim.compute_potential()
            snapshot(sim.particles, sim, compute_system_state(sim.particles),
                     f"{tag}p_", out)

    lat = LATTICE
    with tempfile.TemporaryDirectory() as d:
        sim = Simulation(SimConfig(**lattice_config(OutputDir=d)),
                         mode="synchronized", quiet=True)
        pos, mass = lattice_ics(sim.units.G, sim.units.Hubble)
        sim.set_particles_from_arrays(pos, np.zeros_like(pos), mass,
                                      np.ones(len(pos), np.int32),
                                      pad_to_multiple=len(pos))
        sim.prepare()
        for _ in range(lat["steps"]):
            sim.step()
        out["lat_pos"] = np.asarray(sim.particles.pos)
        out["lat_vel"] = np.asarray(sim.particles.vel)
        out["lat_time"] = np.float64(sim.time)
    return out


# tests/test_periodic_comoving.py:56-87, on the wq walk
LATTICE = dict(m=8, box=10.0, steps=10)


def lattice_config(**changes) -> dict:
    return dict(
        ComovingIntegrationOn=1, PeriodicBoundariesOn=1,
        BoxSize=LATTICE["box"], Omega0=1.0, OmegaLambda=0.0,
        HubbleParam=1.0, TimeBegin=0.02, TimeMax=0.05, ForceMethod="tree",
        TreeWalkEngine="wq", ListMode=0, SIDMOn=0,
        TypeOfTimestepCriterion=0, ErrTolIntAccuracy=0.05,
        MaxSizeTimestep=0.002, SofteningHalo=0.1, SofteningHaloMaxPhys=0.1,
        UnitLength_in_cm=3.085678e24, UnitMass_in_g=1.989e43,
        UnitVelocity_in_cm_per_s=1e5, **changes)


def lattice_ics(G: float, H: float):
    """The m^3 cubic lattice of the box and the masses that make
    Omega0 = 1."""
    m, box = LATTICE["m"], LATTICE["box"]
    g = (np.arange(m) + 0.5) / m * box
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    pos = np.stack([x, y, z], -1).reshape(-1, 3)
    rho_crit = 3 * H * H / (8 * np.pi * G)
    return pos, np.full(len(pos), rho_crit * box ** 3 / len(pos))


GOLDENS = {"slice": (GOLDEN, jax_trajectory),
           "list_slice": (LIST_SLICE_GOLDEN, jax_list_trajectory),
           "list": (LIST_GOLDEN, jax_list_ops),
           "sidm": (SIDM_GOLDEN, jax_sidm_ops),
           "sidm_slice": (SIDM_SLICE_GOLDEN, jax_sidm_trajectory),
           "sidm_walk": (SIDM_WALK_GOLDEN, jax_sidm_walk),
           "run": (RUN_GOLDEN, jax_run),
           "hash": (HASH_GOLDEN, jax_hash),
           "veldisp": (VELDISP_GOLDEN, jax_veldisp),
           "periodic": (PERIODIC_GOLDEN, jax_periodic)}


def main(names):
    os.makedirs(_DATA, exist_ok=True)
    for name in names or list(GOLDENS):
        path, fn = GOLDENS[name]
        np.savez_compressed(path, **fn())
        print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1:])
