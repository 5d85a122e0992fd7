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

Each test file has a ``slow`` test that reruns its JAX outputs and holds the
file to them. Rerun this script to regenerate the files (all, or the ones
named: ``slice``, ``list_slice``, ``list``, ``sidm``, ``sidm_slice``):

    python -m tests.make_torch_golden [slice] [list_slice] [list] [sidm]
        [sidm_slice]
"""

import os
import sys

import numpy as np

from sidm_tpu_torch.flagship import DSMC, FLAGSHIP, LISTS, flagship_ics

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


GOLDENS = {"slice": (GOLDEN, jax_trajectory),
           "list_slice": (LIST_SLICE_GOLDEN, jax_list_trajectory),
           "list": (LIST_GOLDEN, jax_list_ops),
           "sidm": (SIDM_GOLDEN, jax_sidm_ops),
           "sidm_slice": (SIDM_SLICE_GOLDEN, jax_sidm_trajectory)}


def main(names):
    os.makedirs(_DATA, exist_ok=True)
    for name in names or list(GOLDENS):
        path, fn = GOLDENS[name]
        np.savez_compressed(path, **fn())
        print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1:])
