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

* ``tests/data/torch_cosmo_sidm_golden.npz`` (tests/test_torch_cosmo_lists.py,
  tests/test_torch_cosmo_dsmc.py, tests/test_torch_cosmo_veldisp.py): the
  cached lists, DSMC and the velocity-dispersion pass in periodic and
  comoving runs, on cosmo-sidm's field at N = 512 with mesh 32
  (``csidm_field``; the list checks' at N = 1024, ``csidm_list_inputs``).
  ``rl{g,r}_``: ``record_lists(pbc=)`` on the box's
  tree (geometric opening at skin 0; relative at skin CSIDM["skin"]) and
  ``eval_lists(pbc=)`` on it (``1``) and on its moments refreshed at
  drifted positions wrapped onto the box (``2``); ``d{v}{e}{k}_``: the
  JAX ``Simulation`` with DSMC (``csidm_config``: CrossSection raised) in
  the box (``v`` = ``b``), comoving (``c``) and both (``x``), on the list
  engine (``e`` = ``l``), the walk engine (``w``, ``TreeWalkEngine
  fused``) and the hash engine of the single-program step (``h``),
  prepare + CSIDM["steps"] steps with ``ScatterLog 1`` (``d{v}{e}_sct``:
  the scatter log's records); ``v{p,s}{k}_``: cosmo-veldisp
  (``cvd_config``) on the phased and the single-program step.

* ``tests/data/torch_walk_golden.npz`` (tests/test_torch_walk.py,
  tests/test_torch_walk_xla.py): JAX ``wq_gravity`` on an n = 2048
  Plummer sphere at depth 8 (``walk_inputs``), with the Pallas kernels in
  interpret mode and opening 0 (``w0_``) and on the XLA path with opening
  1 (``w1_``): acc, pot, overflow, ``n_segs`` and the item counts.

* ``tests/data/torch_gather_golden.npz`` (tests/test_torch_gather.py): JAX
  ``build_octree`` on n = 4096 Plummer and Hernquist halos (some particles
  invalid; ``gather_inputs``): each tree's ``child_start``, ``mac_rows``,
  ``quad_rows`` and packed table ``flat_tables(pack_tree(tree))``
  (``g{model}_``).

* ``tests/data/torch_tree_golden.npz`` (tests/test_torch_tree.py): the JAX
  tree on n = 4096 Plummer (depth 8) and Hernquist (depth 11) halos
  (``tree_inputs``): ``bounding_cube`` and ``morton_keys2``
  (``m{model}_``); ``build_octree`` with per-type and uniform softenings
  (``b{model}{0,1}_``) and after two ``refresh_octree`` drifts
  (``r{model}_``): the tree's fields and its packed levels' count, start
  and bmax^2 columns; ``make_windows`` (``w_``) and ``compact_plane`` on a
  random key plane (``c_``).

* ``tests/data/torch_far_golden.npz`` (tests/test_torch_far.py): one level
  of a JAX-built n = 2048 Plummer tree (depth 8) for 8 target groups
  (``f_``: the levels' packed rows and the groups' boxes, targets,
  thresholds); per walk case (``c{i}_``, ``FAR_CASES``) ``far_items`` in
  interpret mode (the far field and the segment, open and big key
  planes), the recording walk's far plane, all through JAX's
  ``compact_plane``, ``_expand_open_wq`` and the walk's big path; per
  record case (``r{name}_``, ``FAR_RECORD_CASES``) the level appended to
  part-full lists by ``_walk_level_keys`` and ``_append_plane`` with the
  demand, the drops and the next frontier.

* ``tests/data/torch_tree_sph_golden.npz`` (tests/test_torch_tree_sph.py):
  JAX's tree SPH engine (``sph_density_fused``, ``hydro_force_fused``) on
  tests/test_fused_sph.py's six cases and a periodic comoving box
  (``tree_sph_inputs``, ``{tag}_``): the density pass's fields and
  ``ovf``, the hydro ``acc``, ``dt_egy`` and ``ovf_h``, the hydro walk's
  node hmax; ``tests/data/torch_tree_sph_steps_golden.npz``
  (tests/test_torch_gas_steps.py): the JAX ``Simulation`` of
  SPH_STEPS_CONFIG with ``SphEngine fused`` on the phased step (``f{k}_``).

Each test file has a ``slow`` test that reruns its JAX outputs and holds the
file to them. Rerun this script to regenerate the files (all, or the ones
named: ``slice``, ``list_slice``, ``list``, ``sidm``, ``sidm_slice``,
``sidm_walk``, ``run``, ``hash``, ``veldisp``, ``periodic``,
``cosmo_sidm``, ``walk``, ``gather``, ``tree``, ``far``, and the others
of ``GOLDENS``, such as ``tree_sph`` and ``tree_sph_steps``):

    python -m tests.make_torch_golden [slice] [list_slice] [list] [sidm]
        [sidm_slice] [sidm_walk] [run] [hash] [veldisp] [periodic]
        [cosmo_sidm] [walk] [gather] [tree] [far] [tree_sph]
        [tree_sph_steps] ...
"""

import os
import sys
import tempfile

import numpy as np

from sidm_tpu_torch.flagship import (COSMO, COSMO_BOX, COSMO_FIELD_SIGMA,
                                     COSMO_SIDM, COSMO_VELDISP, DSMC,
                                     FLAGSHIP, LISTS, VELDISP, cosmo_ics,
                                     cosmo_softening, flagship_ics)

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
    out.update(jax_k3_ref())
    out.update(jax_list_refits(out["tiny_need"]))
    return out


def pallasfar():
    """scripts/pallasfar.py as a module (it imports JAX)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "pallasfar.py")
    spec = importlib.util.spec_from_file_location("pallasfar", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# scripts/pallasfar.py's chunk: NU units of 32 node rows, NG groups
K3 = dict(nu=2048, ng=16384)


def k3_inputs():
    """(rows, tgt) numpy of scripts/pallasfar.py's ``make_chunk(
    default_rng(0))`` (NU = 2048 units of 32 rows), the same draws."""
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((K3["nu"] * 32, 16)).astype(np.float32)
    rows[:, 3] = np.abs(rows[:, 3])
    rows[:, 14] = 1.0 / 0.3
    np.sort(rng.integers(0, K3["ng"], K3["nu"]))        # the unit groups
    tgt = rng.standard_normal((K3["nu"], 256)).astype(np.float32)
    tgt[:, 192:] = 1.0 / 0.3
    return rows, tgt


def jax_k3_ref() -> dict:
    """``k3_ref{c}``: scripts/pallasfar.py's ``xla_ref`` (a0, a1, a2, pot)
    on k3_inputs(), which equal its ``make_chunk``'s."""
    import jax.numpy as jnp
    mod = pallasfar()
    rows, tgt = k3_inputs()
    r2, t2, _ = mod.make_chunk(np.random.default_rng(0))
    assert np.array_equal(rows, np.asarray(r2))
    assert np.array_equal(tgt, np.asarray(t2))
    assert (mod.NU, mod.NG) == (K3["nu"], K3["ng"])
    return {f"k3_ref{c}": np.asarray(x) for c, x in enumerate(
        mod.xla_ref(jnp.asarray(rows), jnp.asarray(tgt)))}


def jax_list_refits(need) -> dict:
    """The JAX Simulation's cap refits from TINY_CAPS at the tiny record's
    demand (doubled after each grown refit), four times: ``refit_grew``
    (4,) and ``refit_caps`` (4, 4) [far, near, used, level] (zeros where it
    did not grow)."""
    from sidm_tpu.config import SimConfig as JaxConfig
    from sidm_tpu.ops.list_force import ListConfig as JaxListConfig
    from sidm_tpu.simulation import Simulation as JaxSimulation

    jax_sim = JaxSimulation(JaxConfig(**FLAGSHIP), mode="phased", quiet=True)
    jax_sim._lfc_active = JaxListConfig(**TINY_CAPS)
    need = np.asarray(need)
    grew, caps = [], []
    for _ in range(4):
        g = bool(jax_sim._refit_list_caps(need))
        grew.append(g)
        ref = jax_sim._lfc_override if g else None
        caps.append([ref.far_cap, ref.near_cap, ref.used_cap, ref.lvl_cap]
                    if g else [0, 0, 0, 0])
        if g:
            jax_sim._lfc_active = ref
            need = need * 2
    return {"refit_grew": np.array(grew), "refit_caps": np.array(caps)}


# tests/test_torch_near.py: a Plummer tree's sorted particles (zero-mass
# padding sorted last), 8 target groups and NEAR_K segment keys a group
NEAR_GOLDEN = os.path.join(_DATA, "torch_near_golden.npz")
NEAR_LEVEL = dict(n=2048, depth=8, k=64, seed=9, key_seed=10)


def near_level_setup():
    """The setup of tests/test_torch_near.py: (tree, xr, te, gvalid, keys,
    n_seg) with the port's tree (its structure is JAX's,
    tests/test_torch_tree.py): 8 groups, each with its own leaf segment,
    36 random others and one window across the end of the valid
    particles."""
    import torch
    from sidm_tpu_torch.io import ics
    from sidm_tpu_torch.ops.fused_force import make_windows
    from sidm_tpu_torch.ops.tree import build_octree, level_offsets

    n, depth, K = NEAR_LEVEL["n"], NEAR_LEVEL["depth"], NEAR_LEVEL["k"]
    pos, _, m = ics.plummer(n, seed=NEAR_LEVEL["seed"])
    pos, m = pos.astype(np.float32), m.astype(np.float32)
    m[::53] = 0.0
    eps = np.where(np.arange(n) % 2 == 0, 0.05, 0.08).astype(np.float32)
    tree = build_octree(torch.tensor(pos), torch.tensor(m), torch.tensor(eps),
                        torch.tensor(m > 0), depth=depth)
    valid_s = torch.tensor(m > 0)[tree.perm]
    pidx, gvalid = make_windows(tree.keys_s, valid_s, n, depth)
    pick = torch.linspace(0, int(gvalid.any(1).sum()) - 1, 8).long()
    pidx, gvalid = pidx[pick], gvalid[pick]
    xr = tree.pos_s[pidx]
    te = torch.where(gvalid, tree.eps_s[pidx], torch.ones(()))
    offs = level_offsets(n, depth)
    start = tree.node_start[offs[depth]:].numpy()
    cnt = tree.node_count[offs[depth]:].numpy()
    leaves = np.flatnonzero((cnt > 0) & (cnt <= 16))
    nv = int(valid_s.sum())
    rng = np.random.default_rng(NEAR_LEVEL["key_seed"])
    keys = np.full((8, K), 2147483647, np.int32)
    n_seg = np.zeros(8, np.int32)
    for g in range(8):
        own = int(np.flatnonzero((start <= int(pidx[g, 0]))
                                 & (int(pidx[g, 0]) < start + cnt))[0])
        pick_l = rng.choice(leaves, 36, replace=False)
        ks = [start[own] * 32 + cnt[own]] \
            + [start[i] * 32 + cnt[i] for i in pick_l] + [(nv - 3) * 32 + 8]
        n_seg[g] = len(ks)
        keys[g, :len(ks)] = ks
    return tree, xr.numpy(), te.numpy(), gvalid.numpy(), keys, n_seg


def jax_near() -> dict:
    """JAX ``pallas_near.near_items`` in interpret mode on
    near_level_setup's keys (``acc{need_pot}``: the groups' [ax ay az
    pot])."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from types import SimpleNamespace
    from sidm_tpu.ops.fused_force import pack_part16
    from sidm_tpu.ops.pallas_near import near_items, pack_near_fields

    tree, xr, te, _, keys, _ = near_level_setup()
    K, SC, G = NEAR_LEVEL["k"], 16, 64
    part16 = pack_part16(SimpleNamespace(
        pos_s=jnp.asarray(tree.pos_s.numpy()),
        mass_s=jnp.asarray(tree.mass_s.numpy()),
        eps_s=jnp.asarray(tree.eps_s.numpy())))
    ng = keys.shape[0]
    ent = keys.reshape(ng * (K // SC), SC)
    g_of = np.repeat(np.arange(ng, dtype=np.int32), K // SC)
    tgt = np.zeros((ng + 1, G, 8), np.float32)
    tgt[:ng, :, 3] = te
    tgt[:ng, :, 4:7] = xr
    out = {}
    for pot in (True, False):
        acc = near_items(jnp.asarray(g_of), pack_near_fields(
            jnp.asarray(ent), part16), jnp.asarray(tgt), G=G, S=SC * 32,
            need_pot=pot, interpret=True)
        out[f"acc{int(pot)}"] = np.asarray(acc)[:ng, :, :4]
    return out


# tests/test_torch_foundation.py: configuration, state, integration,
# timesteps, softening kernels and ICs of the JAX package
FOUNDATION_GOLDEN = os.path.join(_DATA, "torch_foundation_golden.npz")
FOUNDATION_OUTDIR = "o/"
FOUNDATION_CONFIG = dict(InitCondFile="ics", OutputDir=FOUNDATION_OUTDIR,
                         ResubmitCommand="none", OutputListFilename="x",
                         SIDMOn=0, TreeWalkEngine="wq", ListMode=0,
                         ErrTolTheta=0.7, TreeRefreshSteps=2)
FOUNDATION_BAD = ("NotATag 1.0\n", "TimeMax 1.0\nTimeMax 2.0\n")
FOUNDATION_T = 0.012


def param_text(cfg) -> str:
    """Every field of a SimConfig as a parameter file (OutputListTimes
    left out)."""
    import dataclasses
    lines = ["% written by the test", ""]
    for f in dataclasses.fields(cfg):
        if f.name != "OutputListTimes":
            lines.append(f"{f.name:<30} {getattr(cfg, f.name)}   % value")
    return "\n".join(lines) + "\n"


def foundation_state(seed: int = 0, n: int = 300) -> dict:
    """A particle state with every field randomised (numpy, the port's
    ``state_dict`` layout): the input of the integration and timestep
    checks."""
    from sidm_tpu_torch import state as tstate
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 10
    vel = rng.normal(size=(n, 3)) * 50
    mass = rng.uniform(0.5, 2.0, n)
    ptype = rng.integers(1, 3, n)
    tp = tstate.make_particles(pos, vel, mass, ptype, pad_to_multiple=64)
    npad = tp.pos.shape[0]
    extra = dict(
        accel=rng.normal(size=(npad, 3)) * 100,
        dvel=rng.normal(size=(npad, 3)),
        current_time=rng.uniform(0.0, 0.01, npad),
        hsml=rng.uniform(0.1, 1.0, npad),
        hsml_vd=rng.uniform(0.1, 1.0, npad),
        vel_disp=rng.uniform(1.0, 10.0, npad),
        dens_vd=rng.uniform(0.1, 10.0, npad))
    extra["max_pred_time"] = extra["current_time"] + rng.uniform(
        0, 0.01, npad)
    d = tstate.state_dict(tp)
    for k, v in extra.items():
        d[k] = v.astype(np.float32)
    return d


def foundation_consts(mod, reflection=5.0):
    return mod.StepConsts(G=43007.1, hubble=0.1, omega0=0.3,
                          omega_lambda=0.7, comoving=False, periodic=False,
                          box_size=0.0, no_force=False, no_scatter=False,
                          reflection_radius=reflection)


def foundation_params(mod, criterion, to_array):
    return mod.TimestepParams(
        criterion=criterion, err_tol_int_accuracy=0.025,
        err_tol_vel_scale=0.66, err_tol_dynamical_accuracy=0.004,
        max_size_timestep=0.01, min_size_timestep=0.0, courant_fac=0.15,
        art_bulk_visc=0.75,
        softening_table=to_array(np.array([0.1, 0.3, 0.2, 0.2, 0.2, 1e-30],
                                          np.float32)),
        sidm_on=True, probability_tol=0.2, des_num_ngb=30,
        max_num_ngb_dev=2, cross_section_internal=79.9,
        cross_section_type=0, yukawa_velocity=0.0,
        cross_section_vel_scale=1.0, cross_section_pow_law=0.0, G=43007.1,
        hubble=0.1, omega0=0.3, omega_lambda=0.7, comoving=False)


def foundation_make_inputs():
    rng = np.random.default_rng(1)
    n = 1000
    return (rng.normal(size=(n, 3)), rng.normal(size=(n, 3)),
            rng.uniform(size=n), rng.integers(0, 6, n))


def softening_inputs():
    rng = np.random.default_rng(5)
    r = np.concatenate([[0.0], rng.uniform(0, 3, 4000)]).astype(np.float32)
    h = rng.uniform(0.1, 2.0, r.shape).astype(np.float32)
    return r, h


def jax_foundation() -> dict:
    """The JAX outputs of tests/test_torch_foundation.py: ``cfg_*`` the
    parse of FOUNDATION_CONFIG's parameter file and its units (JSON), the
    two parameter errors' messages; ``ics_*`` the IC generators; ``mk_*``
    ``make_particles``; ``int_*`` the integration functions on
    foundation_state(2); ``ts{criterion}{first}`` the timesteps on
    foundation_state(4) (``vmax``); ``soft{0,1}`` the softening kernels."""
    import dataclasses
    import json
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import sidm_tpu.config as jcfg
    import sidm_tpu.integrate as jint
    import sidm_tpu.kernels as jker
    import sidm_tpu.state as jstate
    import sidm_tpu.timestep as jts
    from sidm_tpu.io import ics as jics

    out = {}
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "param.txt")
        with open(p, "w") as f:
            f.write(param_text(jcfg.SimConfig(**FOUNDATION_CONFIG)))
        a = jcfg.parse_parameter_file(p)
        out["cfg_parse"] = np.array(json.dumps(dataclasses.asdict(a)))
        out["cfg_units"] = np.array(json.dumps(dataclasses.asdict(
            jcfg.set_units(a))))
        for k, text in enumerate(FOUNDATION_BAD):
            with open(p, "w") as f:
                f.write(text)
            try:
                jcfg.parse_parameter_file(p, strict=False)
            except jcfg.ParameterError as e:
                out[f"cfg_error{k}"] = np.array(str(e))
    for gen in ("plummer", "hernquist"):
        for c, x in enumerate(getattr(jics, gen)(500, seed=3)):
            out[f"ics_{gen}{c}"] = np.asarray(x)
    for c, x in enumerate(jics.nfw(500, rho0=1.49e-4, rs=11.14356,
                                   G=43007.1, seed=4)):
        out[f"ics_nfw{c}"] = np.asarray(x)
    jp = jstate.make_particles(*foundation_make_inputs(), pad_to_multiple=256)
    for f in dataclasses.fields(jp):
        out["mk_" + f.name] = np.asarray(getattr(jp, f.name))

    def jstate_of(seed):
        return jstate.Particles(**{k: jnp.asarray(v) for k, v in
                                   foundation_state(seed).items()})

    jp = jstate_of(2)
    jt = jnp.float32(FOUNDATION_T)
    jc = foundation_consts(jint)
    jpos, jvel = jint.predict_positions(jp, jt, jc)
    raw = np.random.default_rng(3).normal(size=jpos.shape).astype(np.float32)
    ja, jo = jint.apply_accel_postfactors(jnp.asarray(raw), jpos, jvel, jt,
                                          jc)
    active = np.asarray(jint.active_mask(jp, jt))
    jq = jint.reflect(jint.advance(jp, jt, jnp.asarray(active), jc), 5.0)
    out.update(int_pos=np.asarray(jpos), int_vel=np.asarray(jvel),
               int_raw=raw, int_acc=np.asarray(ja), int_old=np.asarray(jo),
               int_active=active,
               int_next=np.float64(jint.find_next_time(jp)),
               **{f"int_q_{f}": np.asarray(getattr(jq, f))
                  for f in ("pos", "vel", "dvel", "current_time")})
    jp = jstate_of(4)
    active = np.asarray(jint.active_mask(jp, jt))
    vmax = jts.get_vmax(jp)
    out["ts_vmax"] = np.float64(vmax)
    out["ts_active"] = active
    for criterion in (0, 1, 4):
        for first in (False, True):
            a = jts.find_timesteps(jp, jt, jnp.asarray(active), vmax,
                                   foundation_params(jts, criterion,
                                                     jnp.asarray),
                                   first=first)
            out[f"ts{criterion}{int(first)}"] = np.asarray(a)
    r, h = softening_inputs()
    out["soft0"] = np.asarray(jker.softened_inv_r3(jnp.asarray(r),
                                                   jnp.asarray(h)))
    out["soft1"] = np.asarray(jker.softened_potential(jnp.asarray(r),
                                                      jnp.asarray(h)))
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


COSMO_SIDM_GOLDEN = os.path.join(_DATA, "torch_cosmo_sidm_golden.npz")
# cosmo-sidm's field (flagship.cosmo_ics with a_vel) at N = 512 (the list
# checks' at list_n), mesh 32; CrossSection raised 1e4x (0.7 -> 7000): at
# cosmo-sidm's value nothing of this coarse field scatters in a few steps;
# at 7000 a few pairs do on every engine (the SIDM timestep criterion caps
# each step's probability)
CSIDM = dict(n=512, seed=3, mesh=32, steps=3, cs=7000.0, a_vel=0.1,
             list_n=1024, skin=300.0, drift=100.0, drift_seed=17)
# the box without comoving integration, comoving without the box, both
CSIDM_VARIANTS = {"b": dict(ComovingIntegrationOn=0),
                  "c": dict(PeriodicBoundariesOn=0), "x": {}}
# engine: (mode, changes); JAX's DSMC walk on TreeWalkEngine fused (its
# wq branch raises NameError, ROADMAP C.9)
CSIDM_ENGINES = {"l": ("phased", dict(ListMode=1, TreeWalkEngine="wq")),
                 "w": ("phased", dict(ListMode=0, TreeWalkEngine="fused")),
                 "h": ("synchronized", dict(TreeWalkEngine="wq"))}
CSIDM_FIELDS = ("hsml_vd", "ngb_vd", "dvel")
# cosmo-veldisp on both steps
CVD_MODES = {"p": "phased", "s": "synchronized"}
CVD_FIELDS = ("hsml_vd", "ngb_vd", "vel_disp", "dens_vd")


def csidm_config(variant: str = "x", engine: str = "l", **changes) -> dict:
    """cosmo-sidm's parameters at CSIDM["n"] with mesh CSIDM["mesh"] and
    CrossSection CSIDM["cs"] (as ``flagship.cosmo_config(**COSMO_SIDM)``),
    in variant ``b``/``c``/``x`` on engine ``l``/``w``/``h``."""
    eps, cap = cosmo_softening(CSIDM["n"])
    return {**COSMO, "SofteningHalo": eps, "SofteningHaloMaxPhys": cap,
            "PMGrid": CSIDM["mesh"], **COSMO_SIDM,
            "CrossSection": CSIDM["cs"], **CSIDM_VARIANTS[variant],
            **CSIDM_ENGINES[engine][1], **changes}


def cvd_config(**changes) -> dict:
    """cosmo-veldisp at CSIDM["n"] with mesh CSIDM["mesh"]."""
    eps, cap = cosmo_softening(CSIDM["n"])
    return {**COSMO, "SofteningHalo": eps, "SofteningHaloMaxPhys": cap,
            "PMGrid": CSIDM["mesh"], **COSMO_VELDISP, **changes}


def csidm_field(field_sigma: float = 0.0):
    """(pos, vel, mass) float64 of the tests' cosmo-sidm field."""
    return cosmo_ics(CSIDM["n"], CSIDM["seed"], a_vel=CSIDM["a_vel"],
                     field_sigma=field_sigma)


def csidm_list_inputs():
    """The list checks' inputs (float32) at CSIDM["list_n"]: positions,
    masses, softenings, |a_old| of the relative criterion, and the drifted
    positions wrapped onto the box (a few dozen particles cross a face)."""
    n = CSIDM["list_n"]
    pos, _, mass = cosmo_ics(n, CSIDM["seed"])
    eps = np.full(n, cosmo_softening(n)[0], np.float32)
    rng = np.random.default_rng(CSIDM["drift_seed"])
    old = rng.uniform(0.5, 2.0, n).astype(np.float32) * 1e3
    pos2 = (pos + rng.normal(0.0, CSIDM["drift"], (n, 3))) % COSMO_BOX
    return (pos.astype(np.float32), mass.astype(np.float32), eps, old,
            pos2.astype(np.float32))


def jax_cosmo_sidm() -> dict:
    """The JAX outputs of tests/test_torch_cosmo_lists.py,
    tests/test_torch_cosmo_dsmc.py and tests/test_torch_cosmo_veldisp.py
    (see the module note)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu.config import SimConfig
    from sidm_tpu.diagnostics import compute_system_state
    from sidm_tpu.ops.fused_force import default_depth
    from sidm_tpu.ops.list_force import (ListConfig, eval_lists,
                                         record_lists)
    from sidm_tpu.ops.pm import build_pm_kernel
    from sidm_tpu.ops.tree import build_octree, refresh_octree
    from sidm_tpu.simulation import Simulation

    out = {}
    n = CSIDM["list_n"]
    pos, mass, eps, old, pos2 = csidm_list_inputs()
    kern = build_pm_kernel(COSMO_BOX, n=CSIDM["mesh"], asmth=COSMO["PMAsmth"],
                           rcut_fac=COSMO["PMRcutFac"])
    pbc = (COSMO_BOX, float(kern.alpha), float(kern.rcut))
    out["rl_pbc"] = np.asarray(pbc, np.float64)
    mj, ej = jnp.asarray(mass), jnp.asarray(eps)
    valid = mj > 0
    tree = build_octree(jnp.asarray(pos), mj, ej, valid, box=COSMO_BOX,
                        depth=default_depth(n))
    tree2 = refresh_octree(tree, jnp.asarray(pos2), mj, ej, valid,
                           box=COSMO_BOX)
    lcfg = ListConfig(materialize=False)
    for tag, rel, skin in (("g", False, 0.0), ("r", True, CSIDM["skin"])):
        lists = record_lists(tree, jnp.asarray(old)[tree.perm],
                             valid[tree.perm], theta=0.5, use_relative=rel,
                             err_tol_force_acc=0.005, lcfg=lcfg, skin=skin,
                             pbc=pbc)
        for f in ("far", "near", "nf", "nn", "src", "ovf", "need", "pidx",
                  "gvalid"):
            out[f"rl{tag}_{f}"] = np.asarray(getattr(lists, f))
        for k, t in ((1, tree), (2, tree2)):
            a, p = eval_lists(t, lists, mj, ej, lcfg=lcfg, need_pot=True,
                              pbc=pbc)
            out[f"rl{tag}{k}_acc"] = np.asarray(a)
            out[f"rl{tag}{k}_pot"] = np.asarray(p)

    def state(sim, prefix, fields):
        snapshot(sim.particles, sim, compute_system_state(sim.particles),
                 prefix, out)
        for f in fields:
            out[prefix + f] = np.asarray(getattr(sim.particles, f))

    n = CSIDM["n"]
    cpos, cvel, cmass = csidm_field()
    for v in CSIDM_VARIANTS:
        for e, (mode, _) in CSIDM_ENGINES.items():
            tag = f"d{v}{e}"
            with tempfile.TemporaryDirectory() as d:
                sim = Simulation(SimConfig(**csidm_config(
                    v, e, OutputDir=d, ScatterLog=1)), mode=mode, quiet=True)
                sim.set_particles_from_arrays(cpos, cvel, cmass,
                                              np.ones(n, np.int32))
                sim.prepare()
                state(sim, f"{tag}0_", CSIDM_FIELDS)
                for k in range(1, CSIDM["steps"] + 1):
                    _, _, n_scat = sim.step()
                    state(sim, f"{tag}{k}_", CSIDM_FIELDS)
                    out[f"{tag}{k}_n_scat"] = np.int64(n_scat)
                sct = os.path.join(d, "sct_000.0")
                out[f"{tag}_sct"] = (np.fromfile(sct, np.float32)
                                     .reshape(-1, 20) if os.path.exists(sct)
                                     else np.zeros((0, 20), np.float32))
    vpos, vvel, vmass = csidm_field(COSMO_FIELD_SIGMA)
    for t, mode in CVD_MODES.items():
        with tempfile.TemporaryDirectory() as d:
            sim = Simulation(SimConfig(**cvd_config(OutputDir=d)),
                             mode=mode, quiet=True)
            sim.set_particles_from_arrays(vpos, vvel, vmass,
                                          np.ones(n, np.int32))
            sim.prepare()
            state(sim, f"v{t}0_", CVD_FIELDS)
            for k in range(1, CSIDM["steps"] + 1):
                sim.step()
                state(sim, f"v{t}{k}_", CVD_FIELDS)
    return out


WALK_GOLDEN = os.path.join(_DATA, "torch_walk_golden.npz")
# tests/test_torch_walk.py's Plummer sphere (n, depth, the seed of its
# positions) and the JAX runs' small super-blocks
WALK = dict(n=2048, depth=8, seed=5, eps=0.05, wq_block=64,
            wq_near_block=256)


def walk_inputs(opening: int):
    """(pos, mass, eps, |a_old|) float32 of the walk checks: the Plummer
    sphere; |a_old| 0 for opening 0, the direct sum's for opening 1."""
    import torch

    from sidm_tpu_torch.io import ics
    from sidm_tpu_torch.ops.direct import direct_gravity

    n = WALK["n"]
    pos, _, m = ics.plummer(n, seed=WALK["seed"])
    pos, m = pos.astype(np.float32), m.astype(np.float32)
    eps = np.full(n, WALK["eps"], np.float32)
    old = np.zeros(n, np.float32)
    if opening == 1:
        a, _ = direct_gravity(torch.tensor(pos), torch.tensor(m),
                              torch.tensor(eps), with_potential=False)
        old = np.linalg.norm(a.numpy(), axis=1).astype(np.float32)
    return pos, m, eps, old


def jax_walk() -> dict:
    """JAX ``wq_gravity`` on walk_inputs: opening 0 with the Pallas kernels
    in interpret mode (``w0_``), opening 1 on the XLA path (``w1_``)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu.ops.fused_force import FusedConfig
    from sidm_tpu.ops.wq_force import wq_gravity

    out = {}
    blocks = dict(wq_block=WALK["wq_block"],
                  wq_near_block=WALK["wq_near_block"])
    for opening, cfg in ((0, FusedConfig(wq_pallas=True, **blocks)),
                         (1, FusedConfig(**blocks))):
        pos, m, eps, old = walk_inputs(opening)
        acc, pot, info = wq_gravity(
            jnp.asarray(pos), jnp.asarray(m), jnp.asarray(eps),
            jnp.asarray(old), theta=0.5, opening=opening,
            depth=WALK["depth"], config=cfg, return_info=True)
        out[f"w{opening}_acc"] = np.asarray(acc)
        out[f"w{opening}_pot"] = np.asarray(pot)
        for k in ("ovf_items", "n_segs", "max_walk_items", "max_near_items"):
            out[f"w{opening}_{k}"] = np.int64(np.asarray(info[k]))
    return out


GATHER_GOLDEN = os.path.join(_DATA, "torch_gather_golden.npz")
# tests/test_torch_gather.py's halos: model -> tree depth
GATHER = dict(n=4096, seed=21, eps=0.05, invalid_every=53)
GATHER_MODELS = {"plummer": 8, "hernquist": 11}


def gather_inputs(model: str):
    """(pos, mass, eps, valid) of the gather checks' n = 4096 halo."""
    from sidm_tpu_torch.io import ics

    n = GATHER["n"]
    pos, _, m = getattr(ics, model)(n, seed=GATHER["seed"])
    valid = np.ones(n, bool)
    valid[::GATHER["invalid_every"]] = False
    return (pos.astype(np.float32), m.astype(np.float32),
            np.full(n, GATHER["eps"], np.float32), valid)


def jax_gather() -> dict:
    """JAX ``build_octree`` on gather_inputs at each model's depth: the
    tree's ``child_start``, ``mac_rows`` and ``quad_rows``, and its packed
    table ``flat_tables(pack_tree(tree))`` (``g{model}_``)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu.ops import fused_force as jff
    from sidm_tpu.ops.list_force import flat_tables
    from sidm_tpu.ops.tree import build_octree

    out = {}
    for model, depth in GATHER_MODELS.items():
        pos, m, eps, valid = gather_inputs(model)
        jt = build_octree(jnp.asarray(pos), jnp.asarray(m), jnp.asarray(eps),
                          jnp.asarray(valid), depth=depth)
        out[f"g{model}_child_start"] = np.asarray(jt.child_start)
        out[f"g{model}_mac_rows"] = np.asarray(jt.mac_rows)
        out[f"g{model}_quad_rows"] = np.asarray(jt.quad_rows)
        out[f"g{model}_flat"] = np.asarray(flat_tables(jff.pack_tree(jt))[0])
    return out


TREE_GOLDEN = os.path.join(_DATA, "torch_tree_golden.npz")
# tests/test_torch_tree.py's halos: model -> tree depth
TREE_MODELS = {"plummer": 8, "hernquist": 11}
TREE_N = 4096
TREE_FIELDS = ("perm", "keys_s", "node_start", "node_count", "child_start",
               "child_count", "n_nodes", "level_offsets", "origin",
               "extent", "drift", "mac_rows", "quad_rows", "pos_s", "mass_s")
PACKED_COLS = [4, 5, 6, 7, 15]   # pack_tree rows' count, starts, bmax^2


def tree_inputs(model: str, n: int, seed: int, n_invalid: int):
    """(pos, mass, eps, valid) of the tree checks: a halo with n_invalid
    invalid particles and two softenings."""
    from sidm_tpu_torch.io import ics

    pos, _, m = getattr(ics, model)(n, seed=seed)
    valid = np.ones(n, bool)
    valid[np.random.default_rng(seed).choice(n, n_invalid, False)] = False
    eps = np.where(np.arange(n) % 3 == 0, 0.05, 0.08).astype(np.float32)
    return pos.astype(np.float32), m.astype(np.float32), eps, valid


def compact_keys():
    """The compaction check's random key plane (60 % IMAX)."""
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 1000, (37, 256)).astype(np.int32)
    keys[rng.random(keys.shape) < 0.6] = 2147483647
    return keys


def jax_tree() -> dict:
    """The JAX tree functions on tests/test_torch_tree.py's inputs (see the
    module note)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu.ops import fused_force as jff
    from sidm_tpu.ops import morton as jmorton
    from sidm_tpu.ops.tree import build_octree, refresh_octree

    out = {}

    def record(prefix, jt):
        for f in TREE_FIELDS:
            out[prefix + f] = np.asarray(getattr(jt, f))
        levels = [np.asarray(a) for a in jff.pack_tree(jt).levels]
        out[prefix + "packed"] = np.concatenate(
            [a[:, PACKED_COLS] for a in levels])
        out[prefix + "packed_sizes"] = np.asarray([len(a) for a in levels])

    def arrays(*a):
        return [jnp.asarray(x) for x in a]

    for model, depth in TREE_MODELS.items():
        pos, _, _, valid = tree_inputs(model, TREE_N, 1, 100)
        o, e = jmorton.bounding_cube(*arrays(pos, valid))
        hi, lo = jmorton.morton_keys2(jnp.asarray(pos), o, e, depth)
        out[f"m{model}_origin"] = np.asarray(o)
        out[f"m{model}_extent"] = np.float64(e)
        out[f"m{model}_hi"] = np.asarray(hi)
        out[f"m{model}_lo"] = np.asarray(lo)
        for uniform in (False, True):
            pos, m, eps, valid = tree_inputs(model, TREE_N, 2, 97)
            if uniform:
                eps = np.full_like(eps, 0.05)
            record(f"b{model}{int(uniform)}_", build_octree(
                *arrays(pos, m, eps, valid), depth=depth,
                uniform_eps=uniform))
        pos, m, eps, valid = tree_inputs(model, TREE_N, 3, 50)
        jt = build_octree(*arrays(pos, m, eps, valid), depth=depth)
        rng = np.random.default_rng(4)
        for _ in range(2):
            pos = (pos + rng.normal(size=pos.shape) * 0.02).astype(
                np.float32)
            jt = refresh_octree(jt, *arrays(pos, m, eps, valid))
        record(f"r{model}_", jt)
    pos, m, eps, valid = tree_inputs("plummer", TREE_N, 5, 60)
    jt = build_octree(*arrays(pos, m, eps, valid), depth=8)
    vs = valid[np.asarray(jt.perm)]
    jp, jv, *_ = jff.make_windows(jt.keys_s, jnp.asarray(vs), TREE_N, 64, 8,
                                  4, 32, True)
    out["w_pidx"], out["w_gvalid"] = np.asarray(jp), np.asarray(jv)
    out["c_out"] = np.asarray(jff.compact_plane(jnp.asarray(compact_keys())))
    return out


FAR_GOLDEN = os.path.join(_DATA, "torch_far_golden.npz")
# tests/test_torch_far.py: one level of a JAX-built n = 2048 Plummer tree
# (depth 8) for 8 of its target groups
FAR = dict(n=2048, depth=8, g=64, wc=128, seed=7, groups=8)
FAR_LEVELS = (3, 5, 8)
FAR_DEFAULT_CAPS = dict(Wn=4096, open_cap=1024, big_cap=8, big_chunks=8)
# (level, last, use_relative, need_pot, leaf_cap, caps); level 5 run as
# the last level has overfull cells, so big keys are emitted. The second
# case caps the opened cells and the next frontier, the third the big
# cells and their chunks, so that every walk counter overflows somewhere.
FAR_CASES = [(3, False, False, True, 16, FAR_DEFAULT_CAPS),
             (3, False, True, False, 16,
              dict(FAR_DEFAULT_CAPS, Wn=64, open_cap=6)),
             (5, True, True, True, 16, dict(FAR_DEFAULT_CAPS, big_cap=1,
                                             big_chunks=1)),
             (FAR["depth"], True, False, False, 16, FAR_DEFAULT_CAPS)]
# name -> (level, last, walk caps, list caps (LF, LN, lvl_cap)); each case
# overflows the cap it is named after
FAR_LVL_BASE = 4681
FAR_RECORD_CASES = {
    "open_cap": (3, False, dict(FAR_DEFAULT_CAPS, open_cap=5),
                 (4096, 4096, None)),
    "wn": (3, False, dict(FAR_DEFAULT_CAPS, Wn=16), (4096, 4096, None)),
    "lvl_cap": (3, False, FAR_DEFAULT_CAPS, (4096, 4096, 16)),
    "far_cap": (3, False, FAR_DEFAULT_CAPS, (96, 4096, None)),
    "near_cap": (3, False, FAR_DEFAULT_CAPS, (4096, 12, None)),
    "big_cap": (5, True, dict(FAR_DEFAULT_CAPS, big_cap=1, big_chunks=1),
                (4096, 4096, None)),
}


def far_level_inputs(s, level, short=0):
    """All nodes of ``level`` of the far checks' tree (``s``: the
    ``f_`` arrays of torch_far_golden.npz, keys without the prefix) as
    every group's frontier; with ``short``, group g's frontier ends
    ``short * g`` ids early (-1 past its live count)."""
    tbl = s[f"tbl{level}"]
    W = tbl.shape[0]
    ng = s["xc"].shape[0]
    n_live = np.maximum(W - short * np.arange(ng), 0).astype(np.int32)
    fids = np.tile(np.arange(W, dtype=np.int32), (ng, 1))
    fids[np.arange(W)[None, :] >= n_live[:, None]] = -1
    s_l = np.float32(float(s["extent"]) / (1 << level))
    return dict(fids=fids, n_live=n_live, tbl=tbl,
                nl_real=int(s[f"nl{level}"]), s_l=s_l, xc=s["xc"],
                te=s["te"], glo=s["glo"], ghi=s["ghi"], oac=s["oac"])


def prefilled_lists(ng, LF, LN, seed):
    """Lists already part full (random fill counts and ids, IMAX tails),
    as numpy (far, near, nf, nn)."""
    rng = np.random.default_rng(seed)
    nf = rng.integers(0, LF + 1, ng).astype(np.int32)
    nn = rng.integers(0, LN + 1, ng).astype(np.int32)
    far = rng.integers(0, 1 << 20, (ng, LF)).astype(np.int32)
    near = rng.integers(0, 1 << 20, (ng, LN)).astype(np.int32)
    far[np.arange(LF)[None, :] >= nf[:, None]] = 2147483647
    near[np.arange(LN)[None, :] >= nn[:, None]] = 2147483647
    return far, near, nf, nn


def jax_far_level() -> dict:
    """The JAX far kernel and the recording walk's level on
    tests/test_torch_far.py's inputs (see the module note)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from sidm_tpu.ops import fused_force as jff
    from sidm_tpu.ops.fused_force import FusedConfig
    from sidm_tpu.ops.list_force import _append_plane, _walk_level_keys
    from sidm_tpu.ops.pallas_far import far_items, pack_rows_t, pack_tgt_scal
    from sidm_tpu.ops.tree import build_octree
    from sidm_tpu.ops.wq_force import _expand_open_wq

    from sidm_tpu_torch.io import ics
    from sidm_tpu_torch.ops.direct import direct_gravity

    IMAX = 2147483647
    N, DEPTH, G, WC = FAR["n"], FAR["depth"], FAR["g"], FAR["wc"]
    out = {}
    # the tree and the inputs of a subset of target groups, built as
    # wq_force.wq_gravity_tree builds them
    pos, _, m = ics.plummer(N, seed=FAR["seed"])
    pos, m = pos.astype(np.float32), m.astype(np.float32)
    m[::61] = 0.0                        # a few invalid particles
    eps = np.full(N, 0.05, np.float32)
    jt = build_octree(jnp.asarray(pos), jnp.asarray(m), jnp.asarray(eps),
                      jnp.asarray(m > 0), depth=DEPTH)
    ft = jff.pack_tree(jt)
    perm = np.asarray(jt.perm)
    pidx, gvalid, *_ = jff.make_windows(jt.keys_s, jnp.asarray((m > 0)[perm]),
                                        N, G, DEPTH, 4, 32, True)
    pidx, gvalid = np.asarray(pidx), np.asarray(gvalid)
    pick = np.linspace(0, int(np.any(gvalid, 1).sum()) - 1,
                       FAR["groups"]).astype(int)
    pidx, gvalid = pidx[pick], gvalid[pick]
    acc, _ = direct_gravity(torch.tensor(pos), torch.tensor(m),
                            torch.tensor(eps), with_potential=False)
    toac = (np.linalg.norm(acc.numpy(), axis=1)[perm] * 0.005).astype(
        np.float32)
    xr = np.asarray(jt.pos_s)[pidx]
    te = np.where(gvalid, np.asarray(jt.eps_s)[pidx], 1.0).astype(np.float32)
    goac = np.where(gvalid, toac[pidx], 0.0)
    glo = np.where(gvalid[..., None], xr, 1e30).min(1).astype(np.float32)
    ghi = np.where(gvalid[..., None], xr, -1e30).max(1).astype(np.float32)
    pos_oac = gvalid & (goac > 0)
    oac = np.where(pos_oac.any(1),
                   np.where(pos_oac, goac, 1e30).min(1), 0.0).astype(
                       np.float32)
    gc = (np.float32(0.5) * (glo + ghi)).astype(np.float32)
    xc = np.where(gvalid[..., None], xr - gc[:, None, :], 0.0).astype(
        np.float32)
    s = dict(xc=xc, te=te, glo=glo, ghi=ghi, oac=oac, gvalid=gvalid,
             extent=np.float64(jt.extent))
    for level in FAR_LEVELS:
        s[f"tbl{level}"] = np.asarray(ft.levels[level])
        s[f"nl{level}"] = np.int64(ft.n_levels[level])
    out.update({f"f_{k}": v for k, v in s.items()})

    def compact(plane):
        return np.asarray(jff.compact_plane(jnp.asarray(plane)))

    def level_keys(inp, *, theta2, use_relative, leaf_cap, last,
                   lvl_base=0):
        ng, W = inp["fids"].shape
        planes = _walk_level_keys(
            jnp.asarray(inp["fids"]), jnp.asarray([int(inp["n_live"].max())]),
            jnp.asarray(inp["tbl"]), jnp.asarray(inp["s_l"]), inp["nl_real"],
            jnp.asarray(inp["glo"])[None], jnp.asarray(inp["ghi"])[None],
            jnp.asarray(inp["oac"])[None], jnp.int32(lvl_base), W=W,
            WC=min(WC, W), last=last, theta2=theta2,
            use_relative=use_relative, cfg=FusedConfig(leaf_cap=leaf_cap),
            NB=1, GB=ng, ng=ng)
        return [np.asarray(p) for p in planes]

    def expand(openk, Wn, open_cap):
        fids, n_live, ovf, _ = _expand_open_wq(
            jnp.asarray(openk), jnp.zeros(2, jnp.int32), Wn=Wn,
            cfg=FusedConfig(open_cap=open_cap))
        return (np.asarray(fids), np.asarray(n_live), int(ovf[0]),
                np.sum(openk != IMAX, axis=1))

    def big(bigk, tbl, big_cap, big_chunks):
        # the JAX walk's overfull-cell path (wq_force.py:508-537,
        # list_force.py:339-366)
        bid = compact(bigk)[:, :big_cap]
        bval = bid != IMAX
        brow = tbl[np.clip(bid, 0, tbl.shape[0] - 1)]
        bstart = brow[..., 5].astype(np.int32)
        bcnt = np.where(bval, brow[..., 4].astype(np.int32), 0)
        k16 = np.arange(big_chunks, dtype=np.int32) * 16
        cst = bstart[:, :, None] + k16[None, None, :]
        ccn = np.clip(bcnt[:, :, None] - k16[None, None, :], 0, 16)
        bkey = np.where(ccn > 0, cst * 32 + ccn, IMAX).reshape(
            bigk.shape[0], big_cap * big_chunks).astype(np.int32)
        bkey = compact(bkey)
        return (bkey, np.sum(bkey != IMAX, axis=1),
                np.sum(bigk != IMAX, axis=1), bcnt)

    for i, (level, last, rel, need_pot, leaf_cap, caps) in enumerate(
            FAR_CASES):
        inp = far_level_inputs(s, level, short=9)
        fids, tbl = inp["fids"], inp["tbl"]
        ng, W = fids.shape
        nc = W // WC
        g_of = np.repeat(np.arange(ng, dtype=np.int32), nc)
        ids = fids.reshape(ng * nc, WC)
        dead = (ids < 0) | (ids >= inp["nl_real"])
        rows = tbl[np.clip(ids, 0, tbl.shape[0] - 1)]
        rows_t = pack_rows_t(jnp.asarray(rows), jnp.asarray(ids),
                             jnp.asarray(dead))
        tgt, scal = pack_tgt_scal(
            jnp.asarray(inp["xc"]), jnp.asarray(inp["te"]),
            jnp.zeros((ng, G, 3), jnp.float32), jnp.asarray(inp["glo"]),
            jnp.asarray(inp["ghi"]), jnp.asarray(inp["oac"]))
        acc_j, keys = far_items(
            jnp.asarray(g_of), jnp.asarray(inp["s_l"]), rows_t, tgt, scal,
            G=G, WC=WC, theta2=0.25, use_relative=rel, leaf_cap=leaf_cap,
            last=last, need_pot=need_pot, interpret=True)
        keys = np.asarray(keys).reshape(ng, nc, 4, WC).transpose(2, 0, 1, 3)
        segk, openk, bigk = keys[:3].reshape(3, ng, W)
        fark = level_keys(inp, theta2=0.25, use_relative=rel,
                          leaf_cap=leaf_cap, last=last)[0]
        pre = f"c{i}_"
        out[pre + "acc"] = np.asarray(acc_j)[:ng, :, :4]
        out[pre + "far"] = compact(fark)
        out[pre + "seg"] = compact(segk)
        out[pre + "n_far"] = np.sum(fark != IMAX, 1)
        out[pre + "n_seg"] = np.sum(segk != IMAX, 1)
        if not last:
            (out[pre + "fids"], out[pre + "n_live"], out[pre + "ovf"],
             out[pre + "n_open"]) = expand(openk, caps["Wn"],
                                           caps["open_cap"])
        else:
            (out[pre + "bkey"], out[pre + "n_bk"], out[pre + "n_big"],
             out[pre + "bcnt"]) = big(bigk, tbl, caps["big_cap"],
                                      caps["big_chunks"])

    for name, (level, last, caps, (LF, LN, lvl_cap)) in \
            FAR_RECORD_CASES.items():
        inp = far_level_inputs(s, level, short=9)
        ng, W = inp["fids"].shape
        far0, near0, nf0, nn0 = prefilled_lists(ng, LF, LN, seed=level)
        fark, segk, openk, bigk = level_keys(
            inp, lvl_base=FAR_LVL_BASE, theta2=0.25, use_relative=True,
            leaf_cap=16, last=last)
        # JAX _record's do_level, then _expand_open or the big path
        LC = W if lvl_cap is None else min(lvl_cap, W)
        live_f, live_n = np.sum(fark != IMAX, 1), np.sum(segk != IMAX, 1)
        zero = jnp.zeros((), jnp.int32)
        far, nf, ovf_f = _append_plane(
            jnp.asarray(far0), jnp.asarray(nf0), zero,
            jnp.asarray(compact(fark)[:, :LC]), LC)
        near, nn, ovf_n = _append_plane(
            jnp.asarray(near0), jnp.asarray(nn0), zero,
            jnp.asarray(compact(segk)[:, :LC]), LC)
        r = dict(need_f=live_f, need_n=live_n,
                 ovf_l=int(np.sum(np.maximum(live_f - LC, 0))
                           + np.sum(np.maximum(live_n - LC, 0))))
        if not last:
            fids, n_live, ovf_open, _ = expand(openk, caps["Wn"],
                                               caps["open_cap"])
            r.update(fids=fids, n_live=n_live, ovf_open=ovf_open)
            r["ovf_l"] += ovf_open
        else:
            bkey, n_bk, n_big, bcnt = big(bigk, inp["tbl"], caps["big_cap"],
                                          caps["big_chunks"])
            over = np.maximum(n_big - caps["big_cap"], 0)
            r["need_n"] = live_n + n_bk + over * caps["big_chunks"]
            near, nn, ovf_n = _append_plane(near, nn, ovf_n,
                                            jnp.asarray(bkey), bkey.shape[1])
            r["ovf_l"] += int(over.sum() + np.sum(
                np.maximum(bcnt - 16 * caps["big_chunks"], 0)))
            r["over"] = int(over.sum())
        r.update(far=np.asarray(far), near=np.asarray(near),
                 nf=np.asarray(nf), nn=np.asarray(nn), ovf_f=int(ovf_f),
                 ovf_n=int(ovf_n))
        out.update({f"r{name}_{k}": np.asarray(v) for k, v in r.items()})
    return out


# ---- the free-space TreePM mesh (PMVacuum) and the per-pair Ewald walk ----

VACUUM_GOLDEN = os.path.join(_DATA, "torch_vacuum_golden.npz")
EWALD_WALK_GOLDEN = os.path.join(_DATA, "torch_ewald_walk_golden.npz")
# tests/test_pm_vacuum.py's two inputs and mesh: the NFW halo of
# test_vacuum_treepm_matches_direct (``1``) and the uniform cube of
# test_vacuum_pm_potential_total_energy (``2``)
VAC_MESH = dict(n1=1500, seed1=5, eps1=0.3, margin1=1.3, n2=1024, seed2=3,
                eps2=0.05, center2=50.0, radius2=55.0, mesh=64, asmth=1.25,
                rcut_fac=4.5)
# flagship-vacuum (flagship_config(PMVacuum=1)) at N = VAC["n"] on the
# phased step, on the lists (``l``) and on the walk (``w``)
VAC = dict(n=2048, seed=12345, steps=3)
VAC_MODES = {"l": dict(ListMode=1), "w": dict(ListMode=0)}
# tests/test_periodic_comoving.py:27-53's clustered box; the all-open
# opening (relative criterion with ErrTolForceAcc 0: the geometric test at
# theta EWALD["theta_open"], under which no cell is far-accepted) on
# EWALD["open_n"] particles of that box
EWALD = dict(n=2048, seed=4, box=10.0, eps=0.05, theta=0.4, open_n=512,
             theta_open=1e-6)
# a clustered cosmo box (cosmo_ics, N = 2048) at geometric theta 0.4: the
# node-level correction's potential bias (ROADMAP.md C.21)
EWALD_COSMO = dict(n=2048, seed=6, theta=0.4)
# cosmo-ewald (cosmo_config(PMGrid=-1)) at CSIDM's N on cosmo-sidm's field
# at the all-open opening: on the single-program (``s``) and the phased
# step (``p``), and on the phased step with DSMC (``d``: cosmo-sidm-walk's
# settings, CrossSection CSIDM["cs"], JAX's walk engine ``fused``)
EWALD_RUN = dict(steps=3)
EWALD_MODES = {"s": ("synchronized", {}), "p": ("phased", {}),
               "d": ("phased", dict(COSMO_SIDM, ListMode=0,
                                    CrossSection=7000.0,
                                    TreeWalkEngine="fused", ScatterLog=1))}


def vacuum_mesh_inputs(k: int):
    """(pos, mass, eps, center, radius) float32 of tests/test_pm_vacuum.py's
    input k (1 or 2) and its mesh region."""
    from sidm_tpu_torch.io import ics
    v = VAC_MESH
    if k == 1:
        pos, _, mass = ics.nfw(v["n1"], rho0=1.49e-4, rs=11.14356,
                               G=43007.1, seed=v["seed1"])
        pos, mass = pos.astype(np.float32), mass.astype(np.float32)
        center = 0.5 * (pos.min(0) + pos.max(0))
        radius = v["margin1"] * float(
            np.sqrt(((pos - center) ** 2).sum(1).max()))
        return pos, mass, np.full(v["n1"], v["eps1"], np.float32), center, \
            radius
    rng = np.random.default_rng(v["seed2"])
    n = v["n2"]
    pos = rng.uniform(20.0, 80.0, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return pos, mass, np.full(n, v["eps2"], np.float32), \
        np.full(3, v["center2"]), v["radius2"]


def vacuum_config(mode: str, **changes) -> dict:
    return {**FLAGSHIP, **LISTS, "PMVacuum": 1, **VAC_MODES[mode],
            **changes}


def ewald_inputs(n: int = None):
    """(pos, mass, eps) float32 of tests/test_periodic_comoving.py:27-53's
    box (its first n particles: half of them the clump)."""
    e = EWALD
    rng = np.random.default_rng(e["seed"])
    N, box = e["n"], e["box"]
    pos = rng.uniform(0, box, (N, 3))
    pos[: N // 2] = 5.0 + rng.normal(0, 0.6, (N // 2, 3))
    pos = np.mod(pos, box).astype(np.float32)
    if n is not None:
        pos = np.concatenate([pos[:n // 2], pos[N // 2:N // 2 + n // 2]])
    n = len(pos)
    return pos, np.full(n, 1.0 / n, np.float32), np.full(n, e["eps"],
                                                         np.float32)


def ewald_config(mode: str, **changes) -> dict:
    """cosmo-ewald at CSIDM["n"] on CSIDM's mesh-free box, all-open."""
    eps, cap = cosmo_softening(CSIDM["n"])
    return {**COSMO, "SofteningHalo": eps, "SofteningHaloMaxPhys": cap,
            "PMGrid": -1, "TypeOfOpeningCriterion": 1, "ErrTolForceAcc": 0.0,
            "ErrTolTheta": EWALD["theta_open"], **EWALD_MODES[mode][1],
            **changes}


def ewald_tiles():
    """Pairs of the Ewald walk's far and near passes on a tree of
    EWALD["open_n"] particles of the clustered box: per target group
    (64 consecutive sorted particles) the nodes of a random sample of a
    middle level (``pair_n``) and the deepest level's non-empty cells as
    segments (``seg_s``, ``seg_c``, at most 16)."""
    return dict(level=4, per_group=24, seed=21)


def jax_vacuum() -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu.config import SimConfig
    from sidm_tpu.diagnostics import compute_system_state
    from sidm_tpu.ops import pm
    from sidm_tpu.ops.direct import direct_gravity
    from sidm_tpu.ops.fused_force import (_classify, _far_tile_pbc,
                                          _near_tile)
    from sidm_tpu.simulation import Simulation

    out = {}
    v = VAC_MESH
    for k in (1, 2):
        pos, mass, eps, center, radius = vacuum_mesh_inputs(k)
        pj, mj, ej = jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(eps)
        kern = pm.build_pm_kernel_free(center, radius, n=v["mesh"],
                                       asmth=v["asmth"],
                                       rcut_fac=v["rcut_fac"],
                                       interlace=True)
        a, p = pm.pm_accel_free(kern, pj, mj, with_potential=True)
        out.update({f"vm{k}_acc": np.asarray(a), f"vm{k}_pot": np.asarray(p),
                    f"vm{k}_pot_self": np.float64(kern.pot_self),
                    f"vm{k}_alpha": np.float64(kern.alpha),
                    f"vm{k}_rcut": np.float64(kern.rcut),
                    f"vm{k}_box": np.float64(kern.box),
                    f"vm{k}_origin": np.asarray(kern.origin)})
        ad, pd = direct_gravity(pj, mj, ej, with_potential=True)
        out[f"vm{k}_dacc"], out[f"vm{k}_dpot"] = np.asarray(ad), \
            np.asarray(pd)
        # JAX's own TreePM identity (test_pm_vacuum.py's brute-force short
        # range under rcut) and potential energy
        d = pj[:, None, :] - pj[None, :, :]
        r = jnp.sqrt(jnp.sum(d * d, axis=-1))
        h = 2.8 * jnp.maximum(ej[:, None], ej[None, :])
        off = 1.0 - jnp.eye(len(pos))
        cut = (r <= kern.rcut) * off
        fac = mj[None, :] * pm.short_range_fac(r, h, kern.alpha) * cut
        acc = np.asarray(a - jnp.sum(fac[..., None] * d, axis=1))
        ad = np.asarray(ad)
        rel = (np.linalg.norm(acc - ad, axis=1)
               / np.maximum(np.linalg.norm(ad, axis=1), 1e-20))
        out[f"vm{k}_jax_p99"] = np.float64(np.percentile(rel, 99))
        pp = jnp.sum(mj[None, :] * pm.short_range_pot(r, h, kern.alpha)
                     * cut, axis=1)
        pot = np.asarray(p - mj * kern.pot_self + pp)
        e_pm = 0.5 * float(np.sum(mass * pot))
        e_d = 0.5 * float(np.sum(mass * np.asarray(pd)))
        out[f"vm{k}_jax_energy"] = np.float64(abs(e_pm - e_d) / abs(e_d))

    t = tile_inputs()
    vpbc = (0.0, TILE["alpha"], TILE["rcut"])
    for last in (False, True):
        for rel in (False, True):
            planes = _classify(jnp.asarray(t["rows"]), jnp.asarray(t["glo"]),
                               jnp.asarray(t["ghi"]), jnp.asarray(t["oac"]),
                               jnp.asarray(t["s_l"]), 0.25, rel, 16, last,
                               vpbc)
            for name, pl in zip(("far", "seg", "opn", "big"), planes):
                out[f"vcl{int(last)}{int(rel)}_{name}"] = np.asarray(pl)
    far = out["vcl00_far"]
    rows_far = t["rows"].copy()
    rows_far[..., 3] = np.where(far, rows_far[..., 3], 0.0)
    trr = np.where(far, t["trq"], 0.0).astype(np.float32)
    p16 = jnp.asarray(part16(t["ppos"], t["pmass"], t["peps"]))
    for pot in (False, True):
        da, dp = _far_tile_pbc(jnp.asarray(rows_far), jnp.asarray(trr),
                               jnp.asarray(t["xr"]), jnp.asarray(t["te"]),
                               vpbc, pot)
        out[f"vft{int(pot)}_acc"] = np.asarray(da)
        out[f"vft{int(pot)}_pot"] = np.asarray(dp)
        da, dp = _near_tile(jnp.asarray(t["ent"]), p16, jnp.asarray(t["xr"]),
                            jnp.asarray(t["te"]), pot, vpbc)
        out[f"vnt{int(pot)}_acc"] = np.asarray(da)
        out[f"vnt{int(pot)}_pot"] = np.asarray(dp)

    pos, vel, mass = flagship_ics(VAC["n"], VAC["seed"])
    for tag in VAC_MODES:
        sim = Simulation(SimConfig(**vacuum_config(tag)), mode="phased",
                         quiet=True)
        sim.set_particles_from_arrays(pos, vel, mass,
                                      np.ones(VAC["n"], np.int32))
        sim.prepare()
        snapshot(sim.particles, sim, compute_system_state(sim.particles),
                 f"vs{tag}0_", out)
        for k in range(1, VAC["steps"] + 1):
            sim.step()
            snapshot(sim.particles, sim,
                     compute_system_state(sim.particles), f"vs{tag}{k}_",
                     out)
        kern = sim._pm_kernel_free()
        out[f"vs{tag}_mesh"] = np.array([kern.n, kern.alpha, kern.rcut,
                                         kern.box])
    return out


def jax_ewald_walk() -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu.config import SimConfig
    from sidm_tpu.diagnostics import compute_system_state
    from sidm_tpu.ops.direct import direct_gravity
    from sidm_tpu.ops.ewald import build_ewald_table
    from sidm_tpu.ops.tree import build_octree
    from sidm_tpu.ops.treeforce import WalkConfig, eval_flat, tree_gravity
    from sidm_tpu.simulation import Simulation

    out = {}
    e = EWALD
    with tempfile.TemporaryDirectory() as d:
        tab = build_ewald_table(e["box"], cache_dir=d)
    for tag, n in (("w", None), ("o", e["open_n"])):
        pos, mass, eps = ewald_inputs(n)
        pj, mj, ej = jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(eps)
        a, p = direct_gravity(pj, mj, ej, box=e["box"], ewald=tab)
        out[f"{tag}_dacc"], out[f"{tag}_dpot"] = np.asarray(a), np.asarray(p)
        if tag == "w":
            kw = dict(theta=e["theta"], opening=0)
            old = jnp.zeros(len(pos), jnp.float32)
        else:
            # relative criterion with ErrTolForceAcc 0: the geometric
            # test at theta_open
            kw = dict(theta=e["theta_open"], opening=1,
                      err_tol_force_acc=0.0)
            old = jnp.ones(len(pos), jnp.float32)
        a, p, info = tree_gravity(pj, mj, ej, old, box=e["box"], ewald=tab,
                                  return_info=True, **kw)
        out[f"{tag}_acc"], out[f"{tag}_pot"] = np.asarray(a), np.asarray(p)
        for k in ("dropped", "n_pairs", "n_segs"):
            out[f"{tag}_{k}"] = np.int64(info[k])

    ec = EWALD_COSMO
    cpos, _, cmass = cosmo_ics(ec["n"], ec["seed"])
    cj = (jnp.asarray(cpos, jnp.float32), jnp.asarray(cmass, jnp.float32),
          jnp.full(ec["n"], cosmo_softening(ec["n"])[0], jnp.float32))
    with tempfile.TemporaryDirectory() as d:
        ctab = build_ewald_table(COSMO_BOX, cache_dir=d)
    a, p = direct_gravity(*cj, box=COSMO_BOX, ewald=ctab)
    out["c_dacc"], out["c_dpot"] = np.asarray(a), np.asarray(p)
    a, p = tree_gravity(*cj, jnp.zeros(ec["n"], jnp.float32), box=COSMO_BOX,
                        theta=ec["theta"], opening=0, ewald=ctab)
    out["c_acc"], out["c_pot"] = np.asarray(a), np.asarray(p)

    # the tiles: eval_flat on chosen (group, node) pairs and segments
    pos, mass, eps = ewald_inputs(e["open_n"])
    n = len(pos)
    tree = build_octree(jnp.asarray(pos), jnp.asarray(mass),
                        jnp.asarray(eps), jnp.ones(n, bool), box=e["box"],
                        depth=8)
    tl = ewald_tiles()
    rng = np.random.default_rng(tl["seed"])
    ng = n // 64
    offs = np.asarray(tree.level_offsets)
    lvl = tl["level"]
    cnt = np.asarray(tree.node_count)
    cells = np.arange(offs[lvl], offs[lvl + 1])
    cells = cells[cnt[cells] > 0]
    pair_g = np.repeat(np.arange(ng), tl["per_group"]).astype(np.int32)
    pair_n = np.concatenate([rng.choice(cells, tl["per_group"],
                                        replace=False)
                             for _ in range(ng)]).astype(np.int32)
    deep = np.arange(offs[8], len(cnt))
    deep = deep[cnt[deep] > 0]
    start = np.asarray(tree.node_start)[deep]
    c = np.minimum(cnt[deep], 16)
    seg_g = np.repeat(np.arange(ng), len(deep)).astype(np.int32)
    seg_s = np.tile(start, ng).astype(np.int32)
    seg_c = np.tile(c, ng).astype(np.int32)
    gt = np.asarray(tree.pos_s).reshape(ng, 64, 3)
    ge = np.asarray(tree.eps_s).reshape(ng, 64)
    cfg = WalkConfig()
    P, S = len(pair_g), len(seg_g)
    zp, zs = np.zeros(1, np.int32), np.zeros(1, np.int32)
    for part, wo in (("f", (pair_g, pair_n, P, zs, zs, zs, 0)),
                     ("n", (zp, zp, 0, seg_g, seg_s, seg_c, S))):
        walk = tuple(jnp.asarray(x) for x in wo) + (jnp.int32(0),)
        a, p = eval_flat(tree, jnp.asarray(gt), jnp.asarray(ge), walk, cfg,
                         e["box"], ewald=tab)
        out[f"t{part}_acc"], out[f"t{part}_pot"] = np.asarray(a), \
            np.asarray(p)
    out.update(t_pair_g=pair_g, t_pair_n=pair_n, t_seg_g=seg_g,
               t_seg_s=seg_s, t_seg_c=seg_c,
               t_mac_rows=np.asarray(tree.mac_rows),
               t_quad_rows=np.asarray(tree.quad_rows))

    cpos, cvel, cmass = csidm_field()
    for tag, (mode, _) in EWALD_MODES.items():
        with tempfile.TemporaryDirectory() as d:
            sim = Simulation(SimConfig(**ewald_config(tag, OutputDir=d)),
                             mode=mode, quiet=True)
            sim.set_particles_from_arrays(cpos, cvel, cmass,
                                          np.ones(CSIDM["n"], np.int32))
            sim.prepare()
            snapshot(sim.particles, sim,
                     compute_system_state(sim.particles), f"r{tag}0_", out)
            for k in range(1, EWALD_RUN["steps"] + 1):
                _, _, ns = sim.step()
                snapshot(sim.particles, sim,
                         compute_system_state(sim.particles),
                         f"r{tag}{k}_", out)
                out[f"r{tag}{k}_n_scat"] = np.int64(ns)
            sim.compute_potential()
            snapshot(sim.particles, sim,
                     compute_system_state(sim.particles), f"r{tag}p_", out)
            sct = os.path.join(d, "sct_000.0")
            if os.path.exists(sct):
                out[f"r{tag}_sct"] = np.fromfile(sct, np.float32).reshape(
                    -1, 20)
    return out


# ---- SPH on the hash grid ---------------------------------------------------

SPH_GOLDEN = os.path.join(_DATA, "torch_sph_golden.npz")
SPH_STEPS_GOLDEN = os.path.join(_DATA, "torch_sph_steps_golden.npz")
# tests/test_sph.py's SphParams (its block of 256 is JAX's alone)
SPH_PARAMS = dict(des_num_ngb=32, max_num_ngb_dev=2, art_bulk_visc=0.75,
                  min_egy_spec=0.0, min_gas_hsml=0.0, comoving=False,
                  hubble=0.1, omega0=0.0, omega_lambda=0.0, cap=128)
# tests/test_sph.py's four inputs (``d`` density, ``s`` symmetry, ``c`` the
# clump, ``v`` the converging flows) and ``x``: a periodic comoving box
# (a clump across its corner, a fifth of the particles dark matter,
# padding, warm smoothing lengths and gas state, 60 % active)
SPH_TAGS = ("d", "s", "c", "v", "x")
SPH_X = dict(n=500, n_dm=100, pad=512, box=1.0, a=0.5, dt=0.1, seed=9,
             active=0.6)
SPH_DENS_FIELDS = ("hsml", "density", "div_vel", "curl_vel", "dt_density",
                   "dt_hsml", "ngb_sph")
# tests/test_phased_mode.py::test_phased_gas_matches_synchronized on the wq
# walk: a Plummer sphere, half gas, 3 steps on each step
SPH_STEPS_CONFIG = dict(
    GravityConstantInternal=1.0, UnitLength_in_cm=1.0, UnitMass_in_g=1.0,
    UnitVelocity_in_cm_per_s=1.0, ForceMethod="tree",
    TypeOfTimestepCriterion=0, ErrTolIntAccuracy=0.05, CourantFac=0.15,
    MaxSizeTimestep=0.01, TimeBegin=0.0, TimeMax=0.03, SofteningGas=0.05,
    SofteningGasMaxPhys=0.05, SofteningHalo=0.05, SofteningHaloMaxPhys=0.05,
    DesNumNgb=16, MaxNumNgbDeviation=2, InitGasTemp=100.0, SphEngine="cell",
    TreeWalkEngine="wq")
SPH_STEPS = dict(n=1024, seed=3, pad=256, steps=3)
SPH_STEPS_MODES = {"s": "synchronized", "p": "phased"}
SPH_STEP_FIELDS = ("pos", "vel", "egy_spec", "hsml", "density", "accel",
                   "dt_egy", "max_pred_time")
# the gas CLI run: gas-halo's settings on gas_ics(GAS_CLI["n"]), from a
# Gadget IC whose gas has u = 0 (InitGasTemp applies)
GAS_CLI = dict(n=512, seed=21, time_max=8e-4, max_dt=0.01)


def sph_steps_ptype(n: int):
    return np.where(np.arange(n) < n // 2, 0, 1).astype(np.int32)


def gas_cli_config(**changes) -> dict:
    from sidm_tpu_torch.flagship import GAS
    return {**FLAGSHIP, **LISTS, **GAS, "TimeMax": GAS_CLI["time_max"],
            "MaxSizeTimestep": GAS_CLI["max_dt"], **changes}


def gas_cli_ic(snapshot_cls, header_cls):
    """The gas CLI run's Gadget IC as a package's ``Snapshot`` (type
    sorted; the gas's u 0)."""
    from sidm_tpu_torch.flagship import gas_ics
    pos, vel, mass, ptype = gas_ics(GAS_CLI["n"], GAS_CLI["seed"])
    order = np.argsort(ptype, kind="stable")
    n = len(order)
    npart = np.bincount(ptype, minlength=6).astype(np.int32)
    return snapshot_cls(
        header=header_cls(npart=npart, npart_total=npart.copy()),
        pos=pos[order].astype(np.float32), vel=vel[order].astype(np.float32),
        pid=np.arange(1, n + 1, dtype=np.uint32),
        mass=mass[order].astype(np.float32), ptype=ptype[order],
        u=np.zeros(int(npart[0]), np.float32))


def sph_inputs(tag: str) -> dict:
    """The SPH ops' input ``tag`` as numpy: make_particles' ``pos``,
    ``vel``, ``mass``, ``ptype``, ``egy_spec`` and ``pad``; ``state``
    (fields to set after make_particles), ``time``, ``active`` (padded),
    the SphParams ``params`` changes and ``box``."""
    def box_case(n, seed):
        rng = np.random.default_rng(seed)
        return rng, rng.uniform(0, 1, (n, 3)), rng.normal(0, 0.1, (n, 3))

    state, params, box, egy = {}, {}, 0.0, 1.0
    if tag in ("d", "s"):
        n = 400 if tag == "d" else 300
        _, pos, vel = box_case(n, 1 if tag == "d" else 2)
    elif tag == "c":
        n = 256
        rng = np.random.default_rng(3)
        pos = rng.uniform(0, 1, (n, 3))
        pos[:64] = 0.5 + rng.normal(0, 0.02, (64, 3))
        vel = np.zeros((n, 3))
    elif tag == "v":
        n = 400
        rng = np.random.default_rng(4)
        pos = rng.uniform(0, 1, (n, 3))
        vel = np.zeros((n, 3))
        vel[:, 0] = np.where(pos[:, 0] < 0.5, 1.0, -1.0)
        egy = 0.01
    else:
        x = SPH_X
        n, box = x["n"], x["box"]
        rng = np.random.default_rng(x["seed"])
        pos = rng.uniform(0, box, (n, 3))
        pos[:150] = (0.9 * box + rng.normal(0, 0.05, (150, 3))) % box
        vel = rng.normal(0, 0.2, (n, 3))
        npad = x["pad"]
        ng = n - x["n_dm"]

        def pad(a):
            out = np.zeros(npad)
            out[:n] = a
            return out

        egy = rng.uniform(0.5, 1.5, n)
        state = dict(
            current_time=np.full(npad, x["a"] - 0.5 * x["dt"]),
            hsml=pad(np.where(np.arange(n) < ng,
                              rng.uniform(0.05, 0.2, n), 0.0)),
            density=pad(rng.uniform(0.5, 2.0, n)),
            div_vel=pad(rng.normal(0, 1.0, n)),
            curl_vel=pad(rng.uniform(0, 1.0, n)))
        active = np.zeros(npad, bool)
        active[:n] = rng.random(n) < x["active"]
        ptype = np.where(np.arange(n) < ng, 0, 1).astype(np.int32)
        params = dict(comoving=True, omega0=0.3, omega_lambda=0.7)
        return dict(pos=pos, vel=vel, mass=np.full(n, 1.0 / n), ptype=ptype,
                    egy_spec=egy, pad=npad, state=state, time=x["a"],
                    active=active, params=params, box=box)
    return dict(pos=pos, vel=vel, mass=np.full(n, 1.0 / n),
                ptype=np.zeros(n, np.int32), egy_spec=np.full(n, egy),
                pad=n, state=state, time=0.05, active=np.ones(n, bool),
                params=params, box=box)


def jax_sph_ops() -> dict:
    """JAX's ``sph_density`` and ``hydro_force`` on each of SPH_TAGS
    (``{tag}_``): the density pass's fields, the hydro acc and dt_egy,
    and both passes' overflow counts."""
    import dataclasses
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu.ops.sph import SphParams, hydro_force, sph_density
    from sidm_tpu.state import make_particles

    out = {}
    for tag in SPH_TAGS:
        x = sph_inputs(tag)
        p = make_particles(x["pos"], x["vel"], x["mass"], x["ptype"],
                           egy_spec=x["egy_spec"], pad_to_multiple=x["pad"])
        p = dataclasses.replace(p, **{
            k: jnp.asarray(v, getattr(p, k).dtype)
            for k, v in x["state"].items()})
        t = jnp.float32(x["time"])
        active = jnp.asarray(x["active"]) & p.valid
        prm = SphParams(**{**SPH_PARAMS, **x["params"], "block": 256})
        p2, table, ovf = sph_density(p, p.pos, p.vel, t, active, prm,
                                     box=x["box"])
        acc, dt_egy, ovf_h = hydro_force(p2, p.pos, p.vel, t, active, prm,
                                         table, box=x["box"])
        for f in SPH_DENS_FIELDS:
            out[f"{tag}_{f}"] = np.asarray(getattr(p2, f))
        out[f"{tag}_acc"] = np.asarray(acc)
        out[f"{tag}_dt_egy"] = np.asarray(dt_egy)
        out[f"{tag}_ovf"] = np.int64(ovf)
        out[f"{tag}_ovf_h"] = np.int64(ovf_h)
    return out


def jax_sph_steps() -> dict:
    """The JAX Simulation on SPH_STEPS_CONFIG in each of SPH_STEPS_MODES
    (``{tag}{k}_``, after prepare and each step); whether JAX's ``load_ic``
    raises on the gas CLI run's IC (``cli_mixed_raises``), and its
    egy_spec on that IC's all-gas twin (``cli_gas_egy_spec``)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sidm_tpu.config import SimConfig
    from sidm_tpu.io import ics
    from sidm_tpu.io.gadget import GadgetHeader, Snapshot, write_snapshot
    from sidm_tpu.simulation import Simulation

    out = {}
    n = SPH_STEPS["n"]
    pos, vel, mass = ics.plummer(n, seed=SPH_STEPS["seed"])
    for tag, mode in SPH_STEPS_MODES.items():
        sim = Simulation(SimConfig(**SPH_STEPS_CONFIG), mode=mode,
                         quiet=True)
        sim.set_particles_from_arrays(pos, vel, mass, sph_steps_ptype(n),
                                      pad_to_multiple=SPH_STEPS["pad"])
        sim.prepare()
        for k in range(SPH_STEPS["steps"] + 1):
            if k:
                sim.step()
            for f in SPH_STEP_FIELDS:
                out[f"{tag}{k}_{f}"] = np.asarray(getattr(sim.particles, f))
            out[f"{tag}{k}_time"] = np.float64(sim.time)
    # JAX's load_ic hands the u block (the gas's) to make_particles, which
    # wants N values: it raises on an IC that holds gas and another type
    # (ROADMAP C.23). Its InitGasTemp u is read on the IC's all-gas twin.
    cfg = SimConfig(**gas_cli_config())
    with tempfile.TemporaryDirectory() as d:
        ic = os.path.join(d, "ic")
        snap = gas_cli_ic(Snapshot, GadgetHeader)
        write_snapshot(ic, snap)
        try:
            Simulation(cfg, quiet=True).load_ic(ic)
            out["cli_mixed_raises"] = np.int64(0)
        except ValueError:
            out["cli_mixed_raises"] = np.int64(1)
        snap.ptype = np.zeros_like(snap.ptype)
        snap.u = np.zeros(len(snap.ptype), np.float32)
        write_snapshot(ic, snap)
        sim = Simulation(cfg, quiet=True)
        sim.load_ic(ic)
        out["cli_gas_egy_spec"] = np.asarray(sim.particles.egy_spec)
    return out


# ---- SPH on the tree --------------------------------------------------------

TREE_SPH_GOLDEN = os.path.join(_DATA, "torch_tree_sph_golden.npz")
TREE_SPH_STEPS_GOLDEN = os.path.join(_DATA,
                                     "torch_tree_sph_steps_golden.npz")
# tests/test_fused_sph.py's six cases: ``d`` density and ``h`` hydro against
# the brute force, ``p`` periodic, ``m`` momentum, ``c`` the controller's
# convergence, ``x`` mixed types with inactive gas; and ``k``,
# tests/test_torch_sph.py's periodic comoving box (SPH_X: dark matter and
# padding among the gas, warm state, 60 % active in both passes, the
# controller's 4 passes); its FusedConfig and tree depth
TREE_SPH_TAGS = ("d", "h", "p", "m", "c", "x", "k")
TREE_SPH_CFG = dict(group_size=16, group_block=8, break_level=3)
TREE_SPH_DEPTH = 6
TREE_SPH_EPS = 1e-3
TREE_SPH_TIME = 0.05
TREE_SPH_FIELDS = ("hsml", "density", "div_vel", "curl_vel", "dt_density",
                   "dt_hsml", "ngb_sph")


def tree_sph_inputs(tag: str) -> dict:
    """Input ``tag`` as numpy: make_particles' ``pos``, ``vel``, ``mass``,
    ``ptype``, ``egy_spec`` and ``pad``; ``state`` (fields to set after
    make_particles, padded), ``time``, the SphParams changes ``params``,
    ``box``, the controller's ``iters``, the hydro pass's ``active``
    (padded), whether the density pass takes it too (``dens_active``; else
    every valid particle) and whether the case runs the hydro pass
    (``hydro``)."""
    if tag == "k":
        x = sph_inputs("x")
        return dict(x, iters=4, dens_active=True, hydro=True)
    def gas_box(n, seed, k=32):
        rng = np.random.default_rng(seed)
        pos = rng.uniform(0, 1, (n, 3))
        vel = rng.normal(0, 0.1, (n, 3))
        h0 = (3.0 * k / (4 * np.pi * n)) ** (1 / 3)
        return dict(pos=pos, vel=vel, mass=np.full(n, 1.0 / n),
                    ptype=np.zeros(n, np.int32), egy_spec=np.full(n, 1.0),
                    pad=n, state=dict(hsml=h0 * rng.uniform(0.8, 1.3, n)),
                    time=TREE_SPH_TIME, params={}, box=0.0, iters=0,
                    active=np.ones(n, bool), dens_active=False, hydro=True)

    if tag == "d":
        return dict(gas_box(400, 1), hydro=False)
    if tag == "h":
        return gas_box(300, 2)
    if tag == "p":
        return dict(gas_box(256, 3, k=24), box=1.0,
                    params=dict(des_num_ngb=24))
    if tag == "m":
        return gas_box(300, 4)
    if tag == "c":
        x = gas_box(400, 5)
        return dict(x, state=dict(hsml=np.full(400, 0.2)), iters=8,
                    hydro=False)
    rng = np.random.default_rng(6)
    n = 256
    pos = rng.uniform(0, 1, (n, 3))
    ptype = np.zeros(n, np.int32)
    ptype[128:] = 1                                   # half dark matter
    vel = rng.normal(0, 0.1, (n, 3))
    h0 = (3.0 * 16 / (4 * np.pi * 128)) ** (1 / 3)
    active = np.ones(n, bool)
    active[:32] = False                               # inactive gas
    return dict(pos=pos, vel=vel, mass=np.full(n, 1.0 / n), ptype=ptype,
                egy_spec=np.full(n, 1.0), pad=n,
                state=dict(hsml=np.where(ptype == 0, h0, 0.0)),
                time=TREE_SPH_TIME, params=dict(des_num_ngb=16), box=0.0,
                iters=0, active=active, dens_active=False, hydro=True)


def jax_tree_sph_ops() -> dict:
    """JAX's ``sph_density_fused`` and ``hydro_force_fused`` on each of
    TREE_SPH_TAGS (``{tag}_``): the density pass's fields and ``ovf``; for
    the hydro cases ``acc``, ``dt_egy`` and ``ovf_h`` (on the density
    pass's particles), and the hydro walk's node hmax of every level
    (``hmax``: ``pack_sph_tree``'s column 7, levels concatenated)."""
    import dataclasses
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sidm_tpu.ops.fused_force import FusedConfig
    from sidm_tpu.ops.fused_sph import (hydro_force_fused, pack_sph_tree,
                                        sph_density_fused)
    from sidm_tpu.ops.sph import SphParams
    from sidm_tpu.ops.tree import build_octree
    from sidm_tpu.state import make_particles

    cfg = FusedConfig(**TREE_SPH_CFG)
    out = {}
    for tag in TREE_SPH_TAGS:
        x = tree_sph_inputs(tag)
        p = make_particles(x["pos"], x["vel"], x["mass"], x["ptype"],
                           egy_spec=x["egy_spec"], pad_to_multiple=x["pad"])
        p = dataclasses.replace(p, **{
            k: jnp.asarray(v, getattr(p, k).dtype)
            for k, v in x["state"].items()})
        n = p.pos.shape[0]
        eps = jnp.full(n, TREE_SPH_EPS, p.pos.dtype)
        tree = build_octree(p.pos, p.mass, eps, p.mass > 0, box=x["box"],
                            depth=TREE_SPH_DEPTH)
        prm = SphParams(**{**SPH_PARAMS, **x["params"], "block": 256})
        t = jnp.float32(x["time"])
        active = jnp.asarray(x["active"]) & p.valid
        p2, ovf = sph_density_fused(p, p.pos, p.vel, tree, t,
                                    active if x["dens_active"] else p.valid,
                                    prm, cfg=cfg, box=x["box"],
                                    hsml_iters=x["iters"])
        for f in TREE_SPH_FIELDS:
            out[f"{tag}_{f}"] = np.asarray(getattr(p2, f))
        out[f"{tag}_ovf"] = np.asarray(ovf)
        if not x["hydro"]:
            continue
        acc, de, ovf_h = hydro_force_fused(p2, p.pos, p.vel, tree, t,
                                           active, prm, cfg=cfg,
                                           box=x["box"])
        out[f"{tag}_acc"] = np.asarray(acc)
        out[f"{tag}_dt_egy"] = np.asarray(de)
        out[f"{tag}_ovf_h"] = np.asarray(ovf_h)
        hs = jnp.where(p2.is_gas, jnp.maximum(p2.hsml, prm.min_gas_hsml),
                       0.0)[tree.perm]
        st = pack_sph_tree(tree, jnp.zeros((n, 1), p.pos.dtype),
                           hmax_sorted=hs)
        out[f"{tag}_hmax"] = np.concatenate(
            [np.asarray(lv[:, 7]) for lv in st.levels])
    return out


def jax_tree_sph_steps() -> dict:
    """The JAX Simulation on SPH_STEPS_CONFIG with ``SphEngine fused`` on
    the phased step (``f{k}_``, after prepare and each step, as
    jax_sph_steps' runs)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sidm_tpu.config import SimConfig
    from sidm_tpu.io import ics
    from sidm_tpu.simulation import Simulation

    out = {}
    n = SPH_STEPS["n"]
    pos, vel, mass = ics.plummer(n, seed=SPH_STEPS["seed"])
    sim = Simulation(SimConfig(**{**SPH_STEPS_CONFIG, "SphEngine": "fused"}),
                     mode="phased", quiet=True)
    sim.set_particles_from_arrays(pos, vel, mass, sph_steps_ptype(n),
                                  pad_to_multiple=SPH_STEPS["pad"])
    sim.prepare()
    for k in range(SPH_STEPS["steps"] + 1):
        if k:
            sim.step()
        for f in SPH_STEP_FIELDS + ("ngb_sph",):
            out[f"f{k}_{f}"] = np.asarray(getattr(sim.particles, f))
        out[f"f{k}_time"] = np.float64(sim.time)
        out[f"f{k}_ngb_overflow"] = np.int64(
            getattr(sim, "ngb_overflow_total", 0))
    return out


GOLDENS = {"slice": (GOLDEN, jax_trajectory),
           "list_slice": (LIST_SLICE_GOLDEN, jax_list_trajectory),
           "list": (LIST_GOLDEN, jax_list_ops),
           "sidm": (SIDM_GOLDEN, jax_sidm_ops),
           "sidm_slice": (SIDM_SLICE_GOLDEN, jax_sidm_trajectory),
           "sidm_walk": (SIDM_WALK_GOLDEN, jax_sidm_walk),
           "run": (RUN_GOLDEN, jax_run),
           "hash": (HASH_GOLDEN, jax_hash),
           "veldisp": (VELDISP_GOLDEN, jax_veldisp),
           "periodic": (PERIODIC_GOLDEN, jax_periodic),
           "cosmo_sidm": (COSMO_SIDM_GOLDEN, jax_cosmo_sidm),
           "walk": (WALK_GOLDEN, jax_walk),
           "gather": (GATHER_GOLDEN, jax_gather),
           "tree": (TREE_GOLDEN, jax_tree),
           "far": (FAR_GOLDEN, jax_far_level),
           "vacuum": (VACUUM_GOLDEN, jax_vacuum),
           "near": (NEAR_GOLDEN, jax_near),
           "foundation": (FOUNDATION_GOLDEN, jax_foundation),
           "ewald_walk": (EWALD_WALK_GOLDEN, jax_ewald_walk),
           "sph": (SPH_GOLDEN, jax_sph_ops),
           "sph_steps": (SPH_STEPS_GOLDEN, jax_sph_steps),
           "tree_sph": (TREE_SPH_GOLDEN, jax_tree_sph_ops),
           "tree_sph_steps": (TREE_SPH_STEPS_GOLDEN, jax_tree_sph_steps)}


def main(names):
    os.makedirs(_DATA, exist_ok=True)
    for name in names or list(GOLDENS):
        path, fn = GOLDENS[name]
        np.savez_compressed(path, **fn())
        print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1:])
