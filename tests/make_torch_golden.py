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

Each test file has a ``slow`` test that reruns its JAX outputs and holds the
file to them. Rerun this script to regenerate the files (all, or the ones
named: ``slice``, ``list_slice``, ``list``):

    python -m tests.make_torch_golden [slice] [list_slice] [list]
"""

import os
import sys

import numpy as np

from sidm_tpu_torch.flagship import FLAGSHIP, LISTS, flagship_ics

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


GOLDENS = {"slice": (GOLDEN, jax_trajectory),
           "list_slice": (LIST_SLICE_GOLDEN, jax_list_trajectory),
           "list": (LIST_GOLDEN, jax_list_ops)}


def main(names):
    os.makedirs(_DATA, exist_ok=True)
    for name in names or list(GOLDENS):
        path, fn = GOLDENS[name]
        np.savez_compressed(path, **fn())
        print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1:])
