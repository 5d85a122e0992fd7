"""The port's I/O modules against the JAX package's, which need no XLA
compile and run live here: ``io/gadget.py`` (the writer's bytes equal,
each package reading the other's files, multi-file sets, the mass table
against the mass block, the gas blocks), ``io/native.py`` (the native
reader equal to the numpy reader; it raises where JAX falls back),
``io/zic.py`` and ``io/checkpoint.py`` (restart files in both directions,
the scatter log's records).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sidm_tpu.io import checkpoint as jckpt
from sidm_tpu.io import gadget as jgadget
from sidm_tpu.io import zic as jzic
from sidm_tpu.simulation import Simulation as JSimulation
from sidm_tpu_torch import state as tstate
from sidm_tpu_torch.io import checkpoint as tckpt
from sidm_tpu_torch.io import gadget as tgadget
from sidm_tpu_torch.io import native as tnative
from sidm_tpu_torch.io import zic as tzic
from sidm_tpu_torch.simulation import Simulation

torch.set_num_threads(2)


def _snapshot(mod, gas: bool, seed: int = 3):
    """A snapshot of types 1 (one mass: the header's table) and 2 (varied
    masses: the mass block), with ``gas`` also type 0 with u, rho and
    hsml, listed out of type order."""
    rng = np.random.default_rng(seed)
    ng, n1, n2 = (40 if gas else 0), 300, 120
    n = ng + n1 + n2
    ptype = np.concatenate([np.full(n2, 2), np.full(n1, 1),
                            np.zeros(ng, int)]).astype(np.int32)
    mass = np.where(ptype == 1, 0.25, rng.uniform(0.1, 1.0, n))
    hdr = mod.GadgetHeader(time=0.125, redshift=0.5, box_size=10.0,
                           omega0=0.3, omega_lambda=0.7, hubble_param=0.7)
    g = (lambda: rng.uniform(1, 2, ng).astype(np.float32)) if gas \
        else (lambda: None)
    return mod.Snapshot(
        header=hdr, pos=rng.normal(size=(n, 3)).astype(np.float32),
        vel=rng.normal(size=(n, 3)).astype(np.float32),
        pid=rng.permutation(n).astype(np.uint32) + 1,
        mass=mass.astype(np.float32), ptype=ptype, u=g(), rho=g(), hsml=g())


def _files(paths):
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


def _assert_same(read, orig):
    """``read`` (a snapshot read back) holds ``orig``'s particles in type
    order, its gas blocks and its header's scalars."""
    order = np.argsort(np.asarray(orig.ptype), kind="stable")
    for f in ("pos", "vel", "pid", "mass", "ptype"):
        np.testing.assert_array_equal(np.asarray(getattr(read, f)),
                                      np.asarray(getattr(orig, f))[order],
                                      err_msg=f)
    for f in ("u", "rho", "hsml"):
        x, y = getattr(read, f), getattr(orig, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("time", "redshift", "box_size", "omega0", "omega_lambda",
              "hubble_param"):
        assert getattr(read.header, f) == getattr(orig.header, f), f


@pytest.mark.parametrize("gas, num_files", [(False, 1), (True, 1),
                                            (False, 3), (True, 2)])
def test_gadget_bytes_equal_jax_and_read_both_ways(tmp_path, gas, num_files):
    snap = _snapshot(tgadget, gas)
    jsnap = _snapshot(jgadget, gas)
    tpaths = tgadget.write_snapshot(str(tmp_path / "t"), snap, num_files)
    jpaths = jgadget.write_snapshot(str(tmp_path / "j"), jsnap, num_files)
    assert _files(tpaths) == _files(jpaths)
    # each package reads the other's file (numpy reader), equal to what
    # was written and to each other
    a = tgadget.read_snapshot(str(tmp_path / "j"), use_native=False)
    b = jgadget.read_snapshot(str(tmp_path / "t"), use_native=False)
    _assert_same(a, snap)
    _assert_same(b, snap)
    np.testing.assert_array_equal(a.header.npart, b.header.npart)
    np.testing.assert_array_equal(a.header.npart_total, b.header.npart_total)
    assert a.header.num_files == b.header.num_files == num_files
    np.testing.assert_array_equal(a.header.mass, b.header.mass)


def test_mass_table_and_mass_block(tmp_path):
    """A type of one mass goes to the header's table, a type of varied
    masses to the mass block (io.c); the reader expands both."""
    snap = _snapshot(tgadget, gas=False)
    (path,) = tgadget.write_snapshot(str(tmp_path / "s"), snap)
    back = tgadget.read_snapshot(path, use_native=False)
    assert back.header.mass[1] == np.float32(0.25)
    assert back.header.mass[2] == 0.0
    n1, n2 = 300, 120
    # header 256 + pos/vel 12 n + ids 4 n + the type-2 masses, each block
    # with its two 4-byte markers
    n = n1 + n2
    assert os.path.getsize(path) == (8 + 256) + 2 * (8 + 12 * n) \
        + (8 + 4 * n) + (8 + 4 * n2)
    _assert_same(back, snap)


@pytest.mark.parametrize("gas", [False, True])
def test_native_reader_equals_numpy_reader(tmp_path, gas):
    snap = _snapshot(tgadget, gas)
    (path,) = tgadget.write_snapshot(str(tmp_path / "s"), snap)
    a = tgadget.read_snapshot(path)
    b = tgadget.read_snapshot(path, use_native=False)
    for f in ("pos", "vel", "pid", "mass", "ptype", "u"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.header.tobytes() == b.header.tobytes()
    # the native reader returns no rho/hsml (the JAX package's native path)
    assert a.rho is None and a.hsml is None


def test_native_reader_raises_where_jax_falls_back(tmp_path, monkeypatch):
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x00" * 64)
    with pytest.raises(OSError, match="native Gadget reader"):
        tgadget.read_snapshot(str(bad))
    # JAX's native path returns None and its numpy path raises
    with pytest.raises(ValueError, match="block length"):
        jgadget.read_snapshot(str(bad))
    # no compiler: the build raises, it does not fall back to numpy
    monkeypatch.setattr(tnative, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative.shutil, "which", lambda _: None)
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.build()


def test_native_build_is_safe_across_processes(tmp_path):
    """Four processes building the library into one empty directory at
    once (as pytest-xdist workers do) each load a whole library and read
    the same arrays."""
    snap = _snapshot(tgadget, gas=False)
    (path,) = tgadget.write_snapshot(str(tmp_path / "s"), snap)
    # the module alone (numpy and ctypes), without the package's torch
    code = (
        "import sys, pathlib, importlib.util, numpy as np\n"
        "spec = importlib.util.spec_from_file_location('native', sys.argv[3])\n"
        "native = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(native)\n"
        "native._BUILD = pathlib.Path(sys.argv[1])\n"
        "_, pos, _, pid, _, _ = native.read_snapshot_native(sys.argv[2])\n"
        "print(int(pid.astype(np.int64).sum()), float(pos.sum()))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "build"), path,
                               tnative.__file__],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out)
    assert len(set(outs)) == 1
    assert len(list((tmp_path / "build").glob("*.so"))) == 1
    assert not list((tmp_path / "build").glob("tmp*"))


def test_zic_write_read_equals_jax(tmp_path):
    rng = np.random.default_rng(9)
    hr = (rng.normal(size=(200, 3)) * 0.05, rng.normal(size=(200, 3)))
    lr = (rng.normal(size=(120, 3)) * 0.3, rng.normal(size=(120, 3)),
          rng.uniform(1, 5, 120))
    g = 43007.1
    for pmhr in (None, 2.0):
        tzic.write_zic(str(tmp_path / "t"), *hr, *lr, 0.5, pmhr=pmhr)
        jzic.write_zic(str(tmp_path / "j"), *hr, *lr, 0.5, pmhr=pmhr)
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
        a = tzic.read_ic_cluster(str(tmp_path / "j"), g)
        b = jzic.read_ic_cluster(str(tmp_path / "t"), g)
        for f in ("pos", "vel", "mass", "ptype", "pid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        assert a.time == b.time and a.pmhr == b.pmhr
        assert set(np.unique(a.ptype)) <= {1, 2, 3}


def _state(seed=4):
    rng = np.random.default_rng(seed)
    n = 300
    p = tstate.make_particles(rng.normal(size=(n, 3)),
                              rng.normal(size=(n, 3)), rng.uniform(size=n),
                              rng.integers(1, 4, n), pad_to_multiple=64)
    d = tstate.state_dict(p)
    for k, v in d.items():
        if v.dtype.kind == "f":
            d[k] = rng.normal(size=v.shape).astype(v.dtype)
    d["pid"] = np.concatenate([[2 ** 32 - 1, 2 ** 31],
                               d["pid"][2:]]).astype(np.uint32)
    return tstate.state_from_dict(d), d


RUN_VARS = dict(time=0.125, step_count=17, snapshot_count=3,
                time_last_statistics=0.1, time_of_first_snapshot=0.2,
                vmax=123.5, cpu_this_run=42.0)


def test_restart_port_to_jax_and_back(tmp_path):
    p, d = _state()
    path = tckpt.write_restart(str(tmp_path / "t" / "rst"), p, RUN_VARS)
    assert path.endswith("rst.npz") and not os.path.exists(
        str(tmp_path / "t" / "rst.tmp.npz"))
    jp, jrv = jckpt.read_restart(str(tmp_path / "t" / "rst"))
    assert jrv == RUN_VARS
    jd = jckpt.state_dict(jp)
    assert sorted(jd) == sorted(d)
    for k in d:
        assert jd[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(jd[k], d[k], err_msg=k)
    # and JAX's file back into the port
    jckpt.write_restart(str(tmp_path / "j" / "rst"), jp, RUN_VARS)
    tp, trv = tckpt.read_restart(str(tmp_path / "j" / "rst.npz"),
                                 device="cpu")
    assert trv == RUN_VARS
    back = tstate.state_dict(tp)
    for k in d:
        assert back[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    assert tp.pid.dtype == torch.int64 and int(tp.pid[0]) == 2 ** 32 - 1


def test_stopfile(tmp_path):
    assert not tckpt.stopfile_present(str(tmp_path))
    (tmp_path / "stop").write_text("")
    assert tckpt.stopfile_present(str(tmp_path))


class _Out:
    def __init__(self, d):
        self.cfg = type("C", (), {"OutputDir": str(d)})()
        self.snapshot_count = 2


def test_scatter_log_matches_jax_records(tmp_path):
    """The port's writer gives JAX's bytes for the same events (ids past
    2^24 and negative as int32 kept exact), and its reader decodes JAX's
    records."""
    rng = np.random.default_rng(5)
    cap, cnt = 16, 11
    rec = rng.normal(size=(cap, 18)).astype(np.float32)
    ids = rng.integers(-2 ** 31, 2 ** 31 - 1, (cap, 2)).astype(np.int32)
    ids[0] = [2 ** 24 + 1, 2 ** 31 - 1]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    JSimulation._write_scatter_log(_Out(tmp_path / "j"), (rec, ids, cnt))
    events = (torch.tensor(rec), torch.tensor(ids), torch.tensor(cnt))
    for _ in range(2):      # appends
        Simulation._write_scatter_log(_Out(tmp_path / "t"), events)
    jb = (tmp_path / "j" / "sct_002.0").read_bytes()
    tb = (tmp_path / "t" / "sct_002.0").read_bytes()
    assert len(jb) == cnt * 80 and tb == jb + jb
    t, i1, i2, rest = tckpt.read_scatter_log(str(tmp_path / "j" /
                                                 "sct_002.0"))
    np.testing.assert_array_equal(t, rec[:cnt, 0])
    np.testing.assert_array_equal(i1, ids[:cnt, 0])
    np.testing.assert_array_equal(i2, ids[:cnt, 1])
    np.testing.assert_array_equal(rest, rec[:cnt, 1:])
    for a, b in zip(tckpt.read_scatter_log(str(tmp_path / "t" /
                                               "sct_002.0")),
                    jckpt.read_scatter_log(str(tmp_path / "t" /
                                               "sct_002.0"))):
        np.testing.assert_array_equal(a, b)


def test_load_ic_gadget_zic_and_gas_refused(tmp_path):
    """``Simulation.load_ic``: a Gadget file (ICFormat 1) and ZIC ICs
    (ICFormat 3) become the particles JAX's readers give; a gas IC loads
    with the u block at its gas (the single-program step runs SPH), and
    loads the same on the phased step with ``SphEngine auto``, whose SPH
    pass is the tree engine (ROADMAP item 12.2, no longer refused)."""
    from sidm_tpu_torch.config import SimConfig
    snap = _snapshot(tgadget, gas=False)
    (path,) = tgadget.write_snapshot(str(tmp_path / "ic"), snap)
    sim = Simulation(SimConfig(InitCondFile=path, TimeBegin=0.25,
                               TreeWalkEngine="wq"), device="cpu")
    sim.load_ic()
    want = jgadget.read_snapshot(path, use_native=False)
    d = tstate.state_dict(sim.particles)
    n = want.n
    for f in ("pos", "vel", "pid", "mass", "ptype"):
        np.testing.assert_array_equal(d[f][:n], getattr(want, f), err_msg=f)
    assert (d["ptype"][n:] == -1).all()
    assert (d["current_time"][:n] == np.float32(0.25)).all()

    rng = np.random.default_rng(2)
    tzic.write_zic(str(tmp_path / "zic"), rng.normal(size=(64, 3)) * 0.05,
                   rng.normal(size=(64, 3)), rng.normal(size=(32, 3)) * 0.3,
                   rng.normal(size=(32, 3)), rng.uniform(1, 5, 32), 0.5,
                   pmhr=2.0)
    sim = Simulation(SimConfig(InitCondFile=str(tmp_path / "zic"),
                               ICFormat=3, TreeWalkEngine="wq"),
                     device="cpu")
    sim.load_ic()
    z = jzic.read_ic_cluster(str(tmp_path / "zic"), sim.units.G)
    d = tstate.state_dict(sim.particles)
    for f in ("pos", "vel", "mass"):
        np.testing.assert_array_equal(d[f][:96],
                                      getattr(z, f).astype(np.float32))
    np.testing.assert_array_equal(d["ptype"][:96], z.ptype)
    np.testing.assert_array_equal(d["pid"][:96], z.pid)

    (gas,) = tgadget.write_snapshot(str(tmp_path / "gas"),
                                    _snapshot(tgadget, gas=True))
    sim = Simulation(SimConfig(InitCondFile=gas, TreeWalkEngine="wq"),
                     device="cpu")
    sim.load_ic()
    want = jgadget.read_snapshot(gas, use_native=False)
    d = tstate.state_dict(sim.particles)
    n, ng = want.n, int(want.header.npart[0])
    for f in ("pos", "ptype"):
        np.testing.assert_array_equal(d[f][:n], getattr(want, f), err_msg=f)
    # the u block (gas first) at the gas, 0 elsewhere; JAX's load_ic hands
    # the ng values to make_particles, which wants n (ROADMAP C.23)
    np.testing.assert_array_equal(d["egy_spec"][:ng], want.u)
    assert ng == 40 and not d["egy_spec"][ng:].any()
    sim = Simulation(SimConfig(InitCondFile=gas, TreeWalkEngine="wq"),
                     mode="phased", device="cpu")
    sim.load_ic()
    d = tstate.state_dict(sim.particles)
    np.testing.assert_array_equal(d["egy_spec"][:ng], want.u)
    assert sim._sph_engine(sim._use_phased()) == "tree"


def test_events_past_the_cap_are_counted():
    """``collect_events`` keeps the first ``cap`` accepted targets in
    particle order (JAX's ``_collect_events``: an argsort of the accepted
    indices, here in numpy), rows past the count zero; ``Simulation``
    counts the scatters past the cap."""
    from types import SimpleNamespace
    from sidm_tpu_torch.ops.sidm import collect_events
    rng = np.random.default_rng(8)
    n, cap = 1000, 100
    accepted = rng.uniform(size=n) < 0.3
    pj = rng.integers(0, n, n)
    p = SimpleNamespace(
        hsml_vd=torch.tensor(rng.uniform(1, 2, n), dtype=torch.float32),
        vel=torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32),
        pid=torch.tensor(rng.permutation(n) + 2 ** 31, dtype=torch.int64))
    pos = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    dv = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    rec, ids, cnt = collect_events(p, pos, torch.tensor(0.5), torch.tensor(
        accepted), torch.tensor(pj), dv, cap)
    order = np.argsort(np.where(accepted, np.arange(n), n),
                       kind="stable")[:cap]
    i, j = order, pj[order]
    want = np.concatenate([
        np.full((cap, 1), 0.5), p.hsml_vd.numpy()[i, None],
        p.hsml_vd.numpy()[j, None], pos.numpy()[i], pos.numpy()[j],
        p.vel.numpy()[i], p.vel.numpy()[j], dv.numpy()[i]], axis=1)
    assert int(cnt) == cap < accepted.sum()
    np.testing.assert_array_equal(rec.numpy(), want.astype(np.float32))
    pid = p.pid.numpy()
    np.testing.assert_array_equal(
        ids.numpy(), np.stack([pid[i], pid[j]], 1).astype(np.int32))
    few = accepted & (np.arange(n) < 60)
    rec, ids, cnt = collect_events(p, pos, torch.tensor(0.5),
                                   torch.tensor(few), torch.tensor(pj), dv,
                                   cap)
    assert int(cnt) == few.sum()
    assert not rec[int(cnt):].any() and not ids[int(cnt):].any()
    sim = SimpleNamespace(_sidm_params=lambda: SimpleNamespace(
        event_cap=cap))
    info = Simulation._event_info(sim, dict(events=(rec, ids, cnt)), 300)
    assert info["events"][2] == cap and info["events_dropped"] == 200
