"""The port's Simulation in the second slice's configuration (cached
interaction lists, ``ListMode 1``) vs the JAX ``Simulation(mode="phased")``:
N = 2048 NFW halo of bench.py, ``SIDMOn 0``, ``TreeWalkEngine wq``,
``TreeRefreshSteps 4``, prepare + 6 steps and ``compute_potential`` at the
end.

The cadence is the JAX package's, faults included. The JAX skin floor is
dead code (ROADMAP C.2) and the port reproduces it: prepare records at skin
0, so step 1's displacement already exceeds skin/2 and the validity monitor
forces the rebuild of step 2, three steps before the cadence would; step 2
records under the skin learned from step 1, steps 3-5 evaluate the cached
lists on the drifted tree, step 6 records again. JAX evaluates in drift
mode with ``materialize`` on (its default here), the port in the gather
form (ROADMAP C).

The JAX trajectory is frozen in tests/data/torch_list_slice_golden.npz
(tests/make_torch_golden.py); the ``slow`` test reruns it and holds the
file to it. Held, as in tests/test_torch_slice.py: time and timesteps to
rtol 1e-6; pos, vel, accel and pot to a max error of 1e-4 of each array's
largest magnitude; kinetic and potential energy to 1e-5 relative; the step
kinds (rebuild or not) and list use exactly; the skin to rtol 1e-3 (it is
2.5 x the largest displacement rate, a difference of float32 positions
that round differently in the two packages)."""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.diagnostics import compute_system_state
from sidm_tpu_torch.flagship import flagship_ics
from sidm_tpu_torch.simulation import Simulation, resolve_device
from tests.make_torch_golden import (LIST_CONFIG, LIST_SLICE_GOLDEN,
                                     LIST_STEPS, N, SEED,
                                     jax_list_trajectory)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def run():
    """The port's snapshots and cadence state, keyed like the golden
    file, and the per-step list info."""
    pos, vel, mass = flagship_ics(N, SEED)
    sim = Simulation(SimConfig(**LIST_CONFIG), mode="phased", device="cpu")
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32))
    out, infos = {}, []

    def snap(prefix):
        p = sim.particles
        s = compute_system_state(p)
        out[prefix + "time"] = sim.time
        for f in ("pos", "vel", "accel", "max_pred_time", "pot"):
            out[prefix + f] = getattr(p, f).numpy()
        out[prefix + "ekin"] = float(s.energy_kin)
        out[prefix + "epot"] = float(s.energy_pot)

    def cadence(prefix):
        out[prefix + "rebuilt"] = sim.last_step_rebuilt
        out[prefix + "skin"] = sim._skin_now
        out[prefix + "listed"] = sim._lists_cache is not None
        out[prefix + "diag"] = np.array([sim._diag_far, sim._diag_near])
        infos.append(dict(sim.last_list_info))

    sim.prepare()
    cadence("k0_")
    snap("s0_")
    for k in range(1, LIST_STEPS + 1):
        sim.step()
        cadence(f"k{k}_")
        snap(f"s{k}_")
    sim.compute_potential()
    snap(f"p{LIST_STEPS}_")
    return out, infos


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(LIST_SLICE_GOLDEN))


def test_cadence_matches_jax(run, golden):
    out, infos = run
    kinds = [i["kind"] for i in infos]
    assert kinds == ["record", "list", "record", "list", "list", "list",
                     "record"]
    # the dead skin floor, reproduced: the first cycle runs at skin 0 and
    # its first list step trips the validity monitor
    assert infos[0]["skin"] == 0.0
    assert infos[1]["md"] > 0.5 * infos[1]["skin"]
    assert all(i["ovf"] == [0, 0, 0, 0] for i in infos
               if i["kind"] == "record")
    for k in range(LIST_STEPS + 1):
        p = f"k{k}_"
        assert bool(out[p + "rebuilt"]) == bool(golden[p + "rebuilt"]), k
        assert bool(out[p + "listed"]) == bool(golden[p + "listed"]), k
        np.testing.assert_allclose(out[p + "skin"], golden[p + "skin"],
                                   rtol=1e-3)


def test_diag_counters_match_jax(run, golden):
    """Nodes and particle segments the targets interact with, summed after
    every record: the lists hold the same pairs as JAX's."""
    out, _ = run
    for k in range(LIST_STEPS + 1):
        np.testing.assert_array_equal(out[f"k{k}_diag"],
                                      golden[f"k{k}_diag"])


PREFIXES = [f"s{k}_" for k in range(LIST_STEPS + 1)] + [f"p{LIST_STEPS}_"]


def _check_state(out, ref, prefix):
    np.testing.assert_allclose(out[prefix + "time"], ref[prefix + "time"],
                               rtol=1e-6)
    np.testing.assert_allclose(out[prefix + "max_pred_time"],
                               ref[prefix + "max_pred_time"], rtol=1e-6)
    for f in ("pos", "vel", "accel", "pot"):
        scale = max(float(np.abs(ref[prefix + f]).max()), 1e-30)
        err = float(np.abs(out[prefix + f] - ref[prefix + f]).max()) / scale
        assert err <= 1e-4, (f, err)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_state_matches_jax(run, golden, prefix):
    _check_state(run[0], golden, prefix)


def test_energies_match_jax(run, golden):
    for f in ("ekin", "epot"):
        np.testing.assert_allclose(run[0][f"p{LIST_STEPS}_" + f],
                                   golden[f"p{LIST_STEPS}_" + f], rtol=1e-5)


@pytest.mark.parametrize("refits", [3, 0])
def test_overflow_falls_back_to_walk(refits):
    """Caps far below the demand: the record's step is the walk's (the
    force of ListMode 0, bit for bit), the caps are refit and a later
    record fits (the demand moves once old_acc turns the relative
    criterion on); with no refit left the walk takes over for good."""
    pos, vel, mass = flagship_ics(N, SEED)

    def sim_of(**changes):
        sim = Simulation(SimConfig(**{**LIST_CONFIG, **changes}),
                         mode="phased", device="cpu")
        sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32))
        return sim

    sim = sim_of(ListFarCap=32, ListNearCap=32)
    sim.LIST_REFITS = refits
    sim.prepare()
    info = sim.last_list_info
    assert info["kind"] == "walk" and sum(info["ovf"][1:3]) > 0
    walk = sim_of(ListMode=0)
    walk.prepare()
    assert torch.equal(sim.particles.accel, walk.particles.accel)
    for _ in range(refits):
        sim.step()
        info = sim.last_list_info
        if info["kind"] == "record":
            break
        assert info["kind"] == "walk" and sum(info["ovf"]) > 0
    if refits:
        assert info["kind"] == "record" and info["ovf"] == [0, 0, 0, 0]
        assert sim._lfc.far_cap >= info["need"][0]
        assert sim._lfc.lvl_cap is None
    else:
        sim.step()
        assert sim._lists_disabled
        assert sim.last_list_info["kind"] == "walk"


@pytest.mark.parametrize("cap", ["level", "walk"])
def test_walk_cap_drops_fall_back_to_walk(monkeypatch, cap):
    """Drops counted only in ovf[0] (a level cap, or the recording walk's
    opened-cell cap), with the list caps wide enough: the JAX package
    checks ovf[1:] alone and would evaluate these lists with pairs missing
    (ROADMAP C.8). The port recomputes the step with the walk (the force of
    ListMode 0, bit for bit); no list-cap refit can help, so the lists are
    given up and the walk runs from then on."""
    import sidm_tpu_torch.ops.list_force as tlf
    from sidm_tpu_torch.ops.fused_force import FusedConfig
    pos, vel, mass = flagship_ics(N, SEED)

    def sim_of(**changes):
        sim = Simulation(SimConfig(**{**LIST_CONFIG, **changes}),
                         mode="phased", device="cpu")
        sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32))
        return sim

    sim = sim_of()
    if cap == "level":
        sim._lfc = sim._lfc._replace(lvl_cap=8)
    else:
        # the record's walk only: Simulation's own walk keeps its caps
        monkeypatch.setattr(tlf, "FusedConfig",
                            lambda: FusedConfig(open_cap=2))
    sim.prepare()
    info = sim.last_list_info
    assert info["kind"] == "walk"
    assert info["ovf"][0] > 0 and info["ovf"][1:] == [0, 0, 0]
    assert sim._lists_disabled and sim._list_refits == 0
    walk = sim_of(ListMode=0)
    walk.prepare()
    assert torch.equal(sim.particles.accel, walk.particles.accel)
    sim.step()
    assert sim.last_list_info["kind"] == "walk"
    assert sim.last_list_info["ovf"] is None


def test_default_device_is_the_card():
    """No device given: the CUDA card, or an error that names the CPU
    option; never a quiet CPU run."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulation(SimConfig(**LIST_CONFIG), mode="phased")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """The committed golden file is what the JAX Simulation gives now."""
    live = jax_list_trajectory()
    assert sorted(live) == sorted(golden)
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
