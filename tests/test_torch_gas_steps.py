"""Gas on the port's two steps against the JAX ``Simulation`` on the input
of JAX's ``test_phased_gas_matches_synchronized`` (tests/test_phased_mode.py:
a 1024-particle Plummer sphere, half of it gas with u = 0, ``DesNumNgb
16``, ``SphEngine cell``, with ``TreeWalkEngine wq``), with JAX's runs
frozen in tests/data/torch_sph_steps_golden.npz (``python -m
tests.make_torch_golden sph_steps``; the ``slow`` test reruns them): the
single-program step (``mode="synchronized"``) and the phased step
(``"phased"``), prepare + 3 steps at JAX's fixed cap of 96 rows a bucket
and 10 levels (``HASH_CAP_GROWTH`` off: JAX drops rows here, the port
counts them), each held to JAX's run in the same mode after every step at
JAX's own bars (positions to 5e-6, egy_spec to 1e-4 relative and 1e-4
absolute), and the two to each other at the same bars. The phased step
with ``SphEngine fused`` (the tree engine, ``ops/fused_sph.py``, on the
force phase's octree), prepare + 3 steps, held to JAX's run of the same
(tests/data/torch_tree_sph_steps_golden.npz, ``python -m
tests.make_torch_golden tree_sph_steps``) at the same bars, with no walk
drop (JAX's ``ngb_overflow_total`` 0 too). Then the SPH rule (``SphEngine
auto`` or ``fused`` with ``ForceMethod tree`` on the phased step runs the
tree engine; ``cell`` runs the hash engine; the single-program step runs
the hash engine whatever ``SphEngine`` says) and a CLI run: gas-halo's
settings on ``gas_ics(512)`` from a Gadget IC whose gas has u = 0, with
``InitGasTemp``: the loaded egy_spec of the gas is the u that JAX's
``load_ic`` gives the IC's all-gas twin (JAX's raises on the mixed IC,
ROADMAP C.23), the run takes its SPH pass every step, and its last
snapshot's u, rho and hsml blocks read back.
"""

import os

import numpy as np
import pytest
import torch

from sidm_tpu_torch import cli
from sidm_tpu_torch.config import SimConfig, write_parameters_out
from sidm_tpu_torch.io import ics
from sidm_tpu_torch.io.gadget import (GadgetHeader, Snapshot, read_snapshot,
                                      write_snapshot)
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import (GAS_CLI, SPH_STEP_FIELDS, SPH_STEPS,
                                     SPH_STEPS_CONFIG, SPH_STEPS_GOLDEN,
                                     SPH_STEPS_MODES, TREE_SPH_STEPS_GOLDEN,
                                     gas_cli_config, gas_cli_ic,
                                     jax_sph_steps, jax_tree_sph_steps,
                                     sph_steps_ptype)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(SPH_STEPS_GOLDEN))


def _sim(mode, **changes):
    sim = Simulation(SimConfig(**{**SPH_STEPS_CONFIG, **changes}), mode=mode,
                     device="cpu")
    n = SPH_STEPS["n"]
    pos, vel, mass = ics.plummer(n, seed=SPH_STEPS["seed"])
    sim.set_particles_from_arrays(pos, vel, mass, sph_steps_ptype(n),
                                  pad_to_multiple=SPH_STEPS["pad"])
    return sim


@pytest.fixture(scope="module")
def runs():
    out = {}
    for tag, mode in SPH_STEPS_MODES.items():
        sim = _sim(mode)
        sim.HASH_CAP_GROWTH = False
        sim.prepare()
        states, infos = [], [sim.last_sph_info]
        for k in range(SPH_STEPS["steps"] + 1):
            if k:
                sim.step()
                infos.append(sim.last_sph_info)
            states.append({f: getattr(sim.particles, f).numpy()
                           for f in SPH_STEP_FIELDS + ("ptype",)}
                          | dict(time=sim.time))
        out[tag] = (sim, states, infos)
    return out


@pytest.mark.parametrize("tag", list(SPH_STEPS_MODES))
def test_gas_steps_match_jax(runs, golden, tag):
    sim, states, infos = runs[tag]
    assert sim._use_phased() == (SPH_STEPS_MODES[tag] == "phased")
    for k, st in enumerate(states):
        want = {f: golden[f"{tag}{k}_{f}"] for f in SPH_STEP_FIELDS}
        gas = st["ptype"] == 0
        hrel = np.abs(st["hsml"] - want["hsml"])[gas] / want["hsml"][gas]
        print(f"{tag} step {k}: {infos[k]}; pos max diff "
              f"{np.max(np.abs(st['pos'] - want['pos'])):.2e}, egy_spec "
              f"{np.max(np.abs(st['egy_spec'] - want['egy_spec'])):.2e}, "
              f"hsml rel {hrel.max():.2e}")
        assert infos[k]["cap"] == 96 and infos[k]["levels"] == 10
        assert infos[k]["queries"] == int(gas.sum())
        np.testing.assert_allclose(st["pos"], want["pos"], atol=5e-6)
        np.testing.assert_allclose(st["egy_spec"], want["egy_spec"],
                                   rtol=1e-4, atol=1e-4)
        for f in ("hsml", "density", "max_pred_time"):
            np.testing.assert_allclose(st[f], want[f], rtol=1e-4, err_msg=f)
        assert st["time"] == pytest.approx(float(golden[f"{tag}{k}_time"]),
                                           rel=1e-6)
    # JAX's cap drops rows on this sphere: counted, not silent
    assert sum(i["ngb_ovf"] for i in infos) > 0
    assert sim.ngb_overflow_total > 0


@pytest.fixture(scope="module")
def tree_golden():
    return dict(np.load(TREE_SPH_STEPS_GOLDEN))


def test_tree_engine_steps_match_jax(tree_golden):
    """The phased step on the tree engine (``SphEngine fused``) against
    JAX's, after prepare and each of 3 steps, at the file's bars."""
    sim = _sim("phased", SphEngine="fused")
    sim.prepare()
    for k in range(SPH_STEPS["steps"] + 1):
        if k:
            sim.step()
        info = sim.last_sph_info
        st = {f: getattr(sim.particles, f).numpy() for f in
              SPH_STEP_FIELDS + ("ngb_sph", "ptype")}
        want = {f: tree_golden[f"f{k}_{f}"] for f in
                SPH_STEP_FIELDS + ("ngb_sph",)}
        gas = st["ptype"] == 0
        print(f"tree step {k}: {info}; pos max diff "
              f"{np.max(np.abs(st['pos'] - want['pos'])):.2e}, egy_spec "
              f"{np.max(np.abs(st['egy_spec'] - want['egy_spec'])):.2e}, "
              f"ngb flips {int(np.sum(st['ngb_sph'] != want['ngb_sph']))}")
        assert info["engine"] == "tree" and info["drops"] == 0
        assert info["queries"] == int(gas.sum())
        assert int(tree_golden[f"f{k}_ngb_overflow"]) == 0
        np.testing.assert_allclose(st["pos"], want["pos"], atol=5e-6)
        np.testing.assert_allclose(st["egy_spec"], want["egy_spec"],
                                   rtol=1e-4, atol=1e-4)
        for f in ("hsml", "density", "max_pred_time"):
            np.testing.assert_allclose(st[f], want[f], rtol=1e-4, err_msg=f)
        assert sim.time == pytest.approx(float(tree_golden[f"f{k}_time"]),
                                         rel=1e-6)
    assert sim.ngb_overflow_total == 0


def test_gas_phased_matches_synchronized(runs):
    a, b = runs["s"][1][-1], runs["p"][1][-1]
    np.testing.assert_allclose(a["pos"], b["pos"], atol=5e-6)
    np.testing.assert_allclose(a["egy_spec"], b["egy_spec"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("mode,engine,method,tree", [
    ("phased", "auto", "tree", True), ("phased", "fused", "tree", True),
    ("phased", "cell", "tree", False), ("synchronized", "auto", "tree",
                                        False),
    ("synchronized", "fused", "direct", False)])
def test_sph_engine_rule(mode, engine, method, tree):
    """The phased step runs the tree SPH engine under ``SphEngine fused``
    or ``auto`` with ``ForceMethod tree`` and the hash engine under
    ``cell``; the single-program step runs the hash engine whatever
    SphEngine says."""
    sim = _sim(mode, SphEngine=engine, ForceMethod=method,
               TimeMax=SPH_STEPS_CONFIG["MaxSizeTimestep"])
    sim.prepare()
    sim.step()
    assert sim.last_sph_info["engine"] == ("tree" if tree else "hash")
    assert sim.last_sph_info["queries"] == SPH_STEPS["n"] // 2
    assert "gas" in sim.last_phase_wall


def test_gas_cli_run(golden, tmp_path):
    """A CLI run from a Gadget IC whose gas has u = 0: InitGasTemp's u as
    JAX's ``load_ic`` sets it, an SPH pass every step (prepare's included),
    the gas blocks in the last snapshot."""
    ic = str(tmp_path / "ic")
    write_snapshot(ic, gas_cli_ic(Snapshot, GadgetHeader))
    out = str(tmp_path / "out") + "/"
    os.makedirs(out)
    cfg = SimConfig(**gas_cli_config(OutputDir=out, InitCondFile=ic,
                                     ResubmitCommand="none",
                                     OutputListFilename="none"))
    sim = Simulation(cfg, device="cpu")
    sim.load_ic(ic)
    # JAX's load_ic raises on this IC (ROADMAP C.23); its InitGasTemp u is
    # that of the IC's all-gas twin
    assert int(golden["cli_mixed_raises"]) == 1
    u_jax = golden["cli_gas_egy_spec"][:GAS_CLI["n"]]
    assert np.all(u_jax == u_jax[0]) and 600.0 < u_jax[0] < 640.0
    p = sim.particles
    gas = p.ptype.numpy() == 0
    ngas = int(gas.sum())
    assert ngas == int(round(GAS_CLI["n"] / 6))
    np.testing.assert_array_equal(p.egy_spec.numpy()[gas], u_jax[0])
    np.testing.assert_array_equal(p.egy_spec.numpy()[~gas], 0.0)
    param = write_parameters_out(cfg, str(tmp_path))
    calls = []
    orig = Simulation._sph

    def spy(self, *a):
        q = orig(self, *a)
        calls.append(self.last_sph_info)
        return q

    mp = pytest.MonkeyPatch()
    mp.setattr(Simulation, "_sph", spy)
    try:
        assert cli.main([param], device="cpu") == 0
    finally:
        mp.undo()
    with open(os.path.join(out, "info_out")) as f:
        steps = [line for line in f if line.startswith("Begin Step")]
    assert len(calls) == len(steps) + 1 >= 2
    # every gas particle active, but at the step that TimeMax clamps, where
    # none is (its kick times all lie past TimeMax)
    bad = [c for c in calls[:-1] if c["queries"] != ngas or c["ngb_ovf"]
           or c["lvl_clip"]]
    assert not bad and calls[-1]["queries"] in (0, ngas), calls
    snaps = sorted(f for f in os.listdir(out) if f.startswith("snp_"))
    snap = read_snapshot(os.path.join(out, snaps[-1]), use_native=False)
    for blk in (snap.u, snap.rho, snap.hsml):
        assert blk is not None and blk.shape == (ngas,)
        assert np.all(np.isfinite(blk)) and np.all(blk > 0)


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """The committed golden file is what the JAX package gives now."""
    live = jax_sph_steps()
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)


@pytest.mark.slow
def test_tree_golden_is_current_jax_output(tree_golden):
    """The committed tree-engine golden file is what the JAX package gives
    now."""
    live = jax_tree_sph_steps()
    for k, v in live.items():
        np.testing.assert_array_equal(v, tree_golden[k], err_msg=k)
