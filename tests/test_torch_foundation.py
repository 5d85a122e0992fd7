"""PyTorch port (sidm_tpu_torch) vs the JAX package: configuration, state,
integration, timesteps, softening kernels, ICs, refusals, no-jax import.

Inputs are made from a seed with numpy and fed to both packages; float
results agree to rtol 1e-6 (both compute in float32 with the same
operation order up to reassociation of 3-term sums), integers exactly."""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sidm_tpu.config as jcfg
import sidm_tpu.integrate as jint
import sidm_tpu.kernels as jker
import sidm_tpu.state as jstate
import sidm_tpu.timestep as jts
from sidm_tpu.io import ics as jics

import sidm_tpu_torch.config as tcfg
import sidm_tpu_torch.integrate as tint
import sidm_tpu_torch.kernels as tker
import sidm_tpu_torch.state as tstate
import sidm_tpu_torch.timestep as tts
from sidm_tpu_torch.io import ics as tics
from sidm_tpu_torch.simulation import Simulation

torch.set_num_threads(2)

RTOL = 1e-6


def _param_text(cfg):
    lines = ["% written by the test", ""]
    for f in dataclasses.fields(cfg):
        if f.name != "OutputListTimes":
            lines.append(f"{f.name:<30} {getattr(cfg, f.name)}   % value")
    return "\n".join(lines) + "\n"


def test_parse_parameter_file_equal(tmp_path):
    cfg = jcfg.SimConfig(InitCondFile="ics", OutputDir=str(tmp_path / "o"),
                         ResubmitCommand="none", OutputListFilename="x",
                         SIDMOn=0, TreeWalkEngine="wq", ListMode=0,
                         ErrTolTheta=0.7, TreeRefreshSteps=2)
    p = tmp_path / "param.txt"
    p.write_text(_param_text(cfg))
    a = jcfg.parse_parameter_file(str(p))
    b = tcfg.parse_parameter_file(str(p))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(jcfg.set_units(a)) == \
        dataclasses.asdict(tcfg.set_units(b))


@pytest.mark.parametrize("text", ["NotATag 1.0\n",
                                  "TimeMax 1.0\nTimeMax 2.0\n"])
def test_parameter_errors_equal(tmp_path, text):
    p = tmp_path / "bad.txt"
    p.write_text(text)
    with pytest.raises(jcfg.ParameterError) as ej:
        jcfg.parse_parameter_file(str(p), strict=False)
    with pytest.raises(tcfg.ParameterError) as et:
        tcfg.parse_parameter_file(str(p), strict=False)
    assert str(ej.value) == str(et.value)


@pytest.mark.parametrize("gen", ["plummer", "hernquist"])
def test_ics_copy_equal(gen):
    a = getattr(jics, gen)(500, seed=3)
    b = getattr(tics, gen)(500, seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    a = jics.nfw(500, rho0=1.49e-4, rs=11.14356, G=43007.1, seed=4)
    b = tics.nfw(500, rho0=1.49e-4, rs=11.14356, G=43007.1, seed=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _random_state(seed=0, n=300):
    """Matching JAX and port particle states with every field randomised."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 10
    vel = rng.normal(size=(n, 3)) * 50
    mass = rng.uniform(0.5, 2.0, n)
    ptype = rng.integers(1, 3, n)
    jp = jstate.make_particles(pos, vel, mass, ptype, pad_to_multiple=64)
    tp = tstate.make_particles(pos, vel, mass, ptype, pad_to_multiple=64)
    npad = jp.n_padded
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
    jp = jstate.Particles(**{k: jnp.asarray(v) for k, v in d.items()})
    return jp, tstate.state_from_dict(d)


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=rtol,
                               atol=atol)


def test_make_particles_equal():
    rng = np.random.default_rng(1)
    n = 1000
    args = (rng.normal(size=(n, 3)), rng.normal(size=(n, 3)),
            rng.uniform(size=n), rng.integers(0, 6, n))
    jp = jstate.make_particles(*args, pad_to_multiple=256)
    tp = tstate.make_particles(*args, pad_to_multiple=256)
    d = tstate.state_dict(tp)
    for f in dataclasses.fields(jp):
        a = np.asarray(getattr(jp, f.name))
        assert a.dtype == d[f.name].dtype, f.name
        np.testing.assert_array_equal(a, d[f.name], err_msg=f.name)
    back = tstate.state_from_dict(d)
    assert torch.equal(back.pos, tp.pos) and torch.equal(back.pid, tp.pid)


def _consts(mod, reflection=5.0):
    return mod.StepConsts(G=43007.1, hubble=0.1, omega0=0.3,
                          omega_lambda=0.7, comoving=False, periodic=False,
                          box_size=0.0, no_force=False, no_scatter=False,
                          reflection_radius=reflection)


def test_integrate_matches():
    jp, tp = _random_state(2)
    t = np.float32(0.012)
    jt, tt = jnp.float32(t), torch.tensor(t)
    jc, tc = _consts(jint), _consts(tint)
    jpos, jvel = jint.predict_positions(jp, jt, jc)
    tpos, tvel = tint.predict_positions(tp, tt, tc)
    _close(jpos, tpos)
    _close(jvel, tvel)
    raw = np.random.default_rng(3).normal(size=jpos.shape).astype(np.float32)
    ja, jo = jint.apply_accel_postfactors(jnp.asarray(raw), jpos, jvel, jt,
                                          jc)
    ta, to = tint.apply_accel_postfactors(torch.tensor(raw), tpos, tvel, tt,
                                          tc)
    _close(ja, ta, atol=1e-6 * float(np.abs(np.asarray(ja)).max()))
    _close(jo, to)
    active_np = np.asarray(jint.active_mask(jp, jt))
    np.testing.assert_array_equal(active_np, tint.active_mask(tp, tt).numpy())
    assert float(jint.find_next_time(jp)) == float(tint.find_next_time(tp))
    jq = jint.reflect(jint.advance(jp, jt, jnp.asarray(active_np), jc), 5.0)
    tq = tint.reflect(tint.advance(tp, tt, torch.tensor(active_np), tc), 5.0)
    for f in ("pos", "vel", "dvel", "current_time"):
        _close(getattr(jq, f), getattr(tq, f), atol=1e-6 * float(
            np.abs(np.asarray(getattr(jq, f))).max()))


def _params(mod, criterion, to_array):
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


@pytest.mark.parametrize("criterion", [0, 1, 4])
@pytest.mark.parametrize("first", [False, True])
def test_timesteps_match(criterion, first):
    jp, tp = _random_state(4)
    t = np.float32(0.012)
    active = np.asarray(jint.active_mask(jp, jnp.float32(t)))
    vmax_j, vmax_t = jts.get_vmax(jp), tts.get_vmax(tp)
    _close(vmax_j, vmax_t)
    a = jts.find_timesteps(jp, jnp.float32(t), jnp.asarray(active), vmax_j,
                           _params(jts, criterion, jnp.asarray), first=first)
    b = tts.find_timesteps(tp, torch.tensor(t), torch.tensor(active), vmax_t,
                           _params(tts, criterion, torch.tensor),
                           first=first)
    _close(a, b)


def test_softening_kernels_match():
    rng = np.random.default_rng(5)
    r = np.concatenate([[0.0], rng.uniform(0, 3, 4000)]).astype(np.float32)
    h = rng.uniform(0.1, 2.0, r.shape).astype(np.float32)
    for jf, tf in ((jker.softened_inv_r3, tker.softened_inv_r3),
                   (jker.softened_potential, tker.softened_potential)):
        _close(jf(jnp.asarray(r), jnp.asarray(h)),
               tf(torch.tensor(r), torch.tensor(h)), rtol=2e-6)


_BASE = dict(SIDMOn=0, TreeWalkEngine="wq", ListMode=0)


@pytest.mark.parametrize("change", [
    dict(ListMode=1, VelDispOn=1), dict(TreeWalkEngine="fused"),
    dict(SIDMOn=1, ForceMethod="direct"),
    dict(PeriodicBoundariesOn=1, BoxSize=10.0), dict(PMVacuum=1),
    dict(ForceMethod="direct"), dict(ComovingIntegrationOn=1),
    dict(VelDispOn=1)])
def test_unported_configs_refused(change):
    """Each configuration outside the port raises, naming its ROADMAP
    item; VelDispOn is ported (A, item 10): those construct."""
    cfg = tcfg.SimConfig(**{**_BASE, **change})
    if change.get("VelDispOn"):
        assert Simulation(cfg, mode="phased", device="cpu").cfg.VelDispOn
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
    sim = Simulation(cfg, mode="phased", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sim.set_particles_from_arrays(np.zeros((4, 3)), np.zeros((4, 3)),
                                      np.ones(4), np.array([0, 1, 1, 1]))
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
