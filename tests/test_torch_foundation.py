"""PyTorch port (sidm_tpu_torch) vs the JAX package: configuration, state,
integration, timesteps, softening kernels, ICs, refusals, no-jax import.

Inputs are made from a seed with numpy; the JAX package's outputs on them
are frozen in tests/data/torch_foundation_golden.npz
(tests/make_torch_golden.py ``foundation``; the ``slow`` test reruns JAX
and holds the file to them). Float results agree to rtol 1e-6 (both
compute in float32 with the same operation order up to reassociation of
3-term sums), integers exactly."""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import sidm_tpu_torch.config as tcfg
import sidm_tpu_torch.integrate as tint
import sidm_tpu_torch.kernels as tker
import sidm_tpu_torch.state as tstate
import sidm_tpu_torch.timestep as tts
from sidm_tpu_torch.io import ics as tics
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import (FOUNDATION_BAD, FOUNDATION_CONFIG,
                                     FOUNDATION_GOLDEN, FOUNDATION_OUTDIR,
                                     FOUNDATION_T, foundation_consts,
                                     foundation_make_inputs,
                                     foundation_params, foundation_state,
                                     jax_foundation, param_text,
                                     softening_inputs)

torch.set_num_threads(2)

RTOL = 1e-6


@pytest.fixture(scope="module")
def golden():
    with np.load(FOUNDATION_GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _asdict_json(x) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(x)))


def test_parse_parameter_file_equal(tmp_path, golden):
    out = str(tmp_path / "o") + "/"
    cfg = tcfg.SimConfig(**dict(FOUNDATION_CONFIG, OutputDir=out))
    p = tmp_path / "param.txt"
    p.write_text(param_text(cfg))
    b = tcfg.parse_parameter_file(str(p))
    want = json.loads(str(golden["cfg_parse"]))
    assert want["OutputDir"] == FOUNDATION_OUTDIR
    want["OutputDir"] = out
    assert _asdict_json(b) == want
    assert _asdict_json(tcfg.set_units(b)) == json.loads(
        str(golden["cfg_units"]))


@pytest.mark.parametrize("text", list(FOUNDATION_BAD))
def test_parameter_errors_equal(tmp_path, golden, text):
    p = tmp_path / "bad.txt"
    p.write_text(text)
    with pytest.raises(tcfg.ParameterError) as et:
        tcfg.parse_parameter_file(str(p), strict=False)
    k = FOUNDATION_BAD.index(text)
    assert str(et.value) == str(golden[f"cfg_error{k}"])


@pytest.mark.parametrize("gen", ["plummer", "hernquist"])
def test_ics_copy_equal(golden, gen):
    b = getattr(tics, gen)(500, seed=3)
    for c, y in enumerate(b):
        np.testing.assert_array_equal(golden[f"ics_{gen}{c}"], y)
    b = tics.nfw(500, rho0=1.49e-4, rs=11.14356, G=43007.1, seed=4)
    for c, y in enumerate(b):
        np.testing.assert_array_equal(golden[f"ics_nfw{c}"], y)


def _random_state(seed=0):
    """The port's particle state with every field randomised (the JAX
    outputs in the golden file are on the same state)."""
    return tstate.state_from_dict(foundation_state(seed))


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=rtol,
                               atol=atol)


def test_make_particles_equal(golden):
    tp = tstate.make_particles(*foundation_make_inputs(), pad_to_multiple=256)
    d = tstate.state_dict(tp)
    names = [k[3:] for k in golden if k.startswith("mk_")]
    assert sorted(names) == sorted(d)
    for f in names:
        a = golden["mk_" + f]
        assert a.dtype == d[f].dtype, f
        np.testing.assert_array_equal(a, d[f], err_msg=f)
    back = tstate.state_from_dict(d)
    assert torch.equal(back.pos, tp.pos) and torch.equal(back.pid, tp.pid)


def test_integrate_matches(golden):
    tp = _random_state(2)
    tt = torch.tensor(np.float32(FOUNDATION_T))
    tc = foundation_consts(tint)
    tpos, tvel = tint.predict_positions(tp, tt, tc)
    _close(golden["int_pos"], tpos)
    _close(golden["int_vel"], tvel)
    raw = golden["int_raw"]
    ta, to = tint.apply_accel_postfactors(torch.tensor(raw), tpos, tvel, tt,
                                          tc)
    ja = golden["int_acc"]
    _close(ja, ta, atol=1e-6 * float(np.abs(ja).max()))
    _close(golden["int_old"], to)
    active_np = golden["int_active"]
    np.testing.assert_array_equal(active_np, tint.active_mask(tp, tt).numpy())
    assert float(golden["int_next"]) == float(tint.find_next_time(tp))
    tq = tint.reflect(tint.advance(tp, tt, torch.tensor(active_np), tc), 5.0)
    for f in ("pos", "vel", "dvel", "current_time"):
        want = golden["int_q_" + f]
        _close(want, getattr(tq, f), atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("criterion", [0, 1, 4])
@pytest.mark.parametrize("first", [False, True])
def test_timesteps_match(golden, criterion, first):
    tp = _random_state(4)
    t = np.float32(FOUNDATION_T)
    active = golden["ts_active"]
    np.testing.assert_array_equal(
        active, tint.active_mask(tp, torch.tensor(t)).numpy())
    vmax_t = tts.get_vmax(tp)
    _close(golden["ts_vmax"], vmax_t)
    b = tts.find_timesteps(tp, torch.tensor(t), torch.tensor(active), vmax_t,
                           foundation_params(tts, criterion, torch.tensor),
                           first=first)
    _close(golden[f"ts{criterion}{int(first)}"], b)


def test_softening_kernels_match(golden):
    r, h = softening_inputs()
    for k, tf in enumerate((tker.softened_inv_r3, tker.softened_potential)):
        _close(golden[f"soft{k}"], tf(torch.tensor(r), torch.tensor(h)),
               rtol=2e-6)


_BASE = dict(SIDMOn=0, TreeWalkEngine="wq", ListMode=0)


@pytest.mark.parametrize("change", [
    dict(ListMode=1, VelDispOn=1), dict(TreeWalkEngine="fused"),
    dict(SIDMOn=1, ForceMethod="direct"),
    dict(PeriodicBoundariesOn=1, BoxSize=10.0), dict(PMVacuum=1),
    dict(ForceMethod="direct"), dict(ComovingIntegrationOn=1),
    dict(VelDispOn=1)])
def test_unported_configs_refused(change):
    """Each configuration outside the port raises, naming its ROADMAP
    item; VelDispOn (A, item 10), periodic boxes and comoving runs (A,
    item 11's core) and PMVacuum (A, item 11.2) are ported: those
    construct."""
    cfg = tcfg.SimConfig(**{**_BASE, **change})
    if change.get("VelDispOn"):
        assert Simulation(cfg, mode="phased", device="cpu").cfg.VelDispOn
        return
    if change.get("PMVacuum"):
        assert Simulation(cfg, mode="phased", device="cpu")._use_vacuum_pm()
        return
    if change.get("PeriodicBoundariesOn") or change.get(
            "ComovingIntegrationOn"):
        sim = Simulation(cfg, mode="phased", device="cpu")
        assert sim.cfg.PeriodicBoundariesOn or sim.cfg.ComovingIntegrationOn
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulation(cfg, mode="phased")


def test_unported_modes_and_inputs_refused():
    cfg = tcfg.SimConfig(**_BASE)
    with pytest.raises(ValueError, match="mode"):
        Simulation(cfg, mode="adaptive")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulation(cfg.replace(Precision="f64"), mode="phased",
                   device=torch.device("cuda"))
    # gas on the phased step with SphEngine auto: no longer refused, the
    # tree SPH engine (ROADMAP.md A, item 12.2, ported) runs it
    sim = Simulation(cfg, mode="phased", device="cpu")
    sim.set_particles_from_arrays(np.zeros((4, 3)), np.zeros((4, 3)),
                                  np.ones(4), np.array([0, 1, 1, 1]))
    assert sim._sph_engine(sim._use_phased()) == "tree"
    # ForceMethod direct on the phased step (the single-program step of
    # mode="synchronized" below PHASE_THRESHOLD runs it)
    sim = Simulation(cfg.replace(ForceMethod="direct"), mode="synchronized",
                     device="cpu")
    sim.PHASE_THRESHOLD = 64
    sim.set_particles_from_arrays(np.random.default_rng(0).normal(
        size=(64, 3)), np.zeros((64, 3)), np.ones(64), np.ones(64, int))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sim.prepare()


def test_package_imports_no_jax():
    code = ("import sys, pkgutil, importlib, sidm_tpu_torch\n"
            "for m in pkgutil.walk_packages(sidm_tpu_torch.__path__, "
            "'sidm_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(k.startswith('sidm_tpu.') or k == 'sidm_tpu' "
            "for k in sys.modules), 'sidm_tpu imported'\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    """The committed golden file is what the JAX package gives now."""
    live = jax_foundation()
    assert sorted(live) == sorted(golden)
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
