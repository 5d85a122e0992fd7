"""The pieces of the periodic and comoving SIDM slice that the JAX parity
tests do not see on their own, on the CPU:

* ``list_force.max_displacement(box=)``: the minimum image of a
  displacement across each face of the box (what the wrap count and the
  port's list monitors read), the plain difference without ``box`` (JAX's
  monitor);
* ``list_force.compact_traces``: the compact table's raw quadrupole
  traces, the tree's ``trq`` at the used rows and 0 for the zero row;
* ``far_level`` takes the free-space screened mode (a box of 0,
  ``PMVacuum``) in either mode: the open walk's box distance and the cut
  at rcut, the walk's and the record's counts those of its classification;
* ``flagship.cosmo_ics(a_vel=, field_sigma=)``: positions and masses as
  without velocities; the clumps' one-dimensional dispersion a sqrt(G M /
  (6 sqrt(pi) a s)) within 2 % (pooled over the clumps); the uniform part
  at rest, or at ``field_sigma`` times a within 2 %;
* the configurations: cosmo-sidm's ``CrossSection`` is 1 cm^2/g per
  unit of physical mass and area in the h-scaled code units; cosmo-sidm,
  -walk, -veldisp and -small construct, each with its engine's settings
  and on the step its N gives;
* the list-validity monitor in a periodic box without comoving
  integration (the node drift of the lists): particles that cross a face
  are counted in ``Simulation.wrap_records``; under JAX's plain
  difference (``LIST_MONITOR_IMAGE = False``) they end the cycle and the
  learned skin grows past the box; under the minimum image (the default,
  ROADMAP C.20) the cycle goes on and its lists, evaluated at the wrapped
  positions, give a fresh record's force within tests/test_pm.py's TreePM
  bars.
"""

import types

import numpy as np
import pytest
import torch

from sidm_tpu_torch.config import SimConfig, set_units
from sidm_tpu_torch.flagship import (COSMO_BOX, COSMO_FIELD_SIGMA, COSMO_N,
                                     COSMO_SIDM, COSMO_SIDM_WALK,
                                     COSMO_SMALL_N, COSMO_VELDISP,
                                     cosmo_config, cosmo_ics)
from sidm_tpu_torch.ops.far_kernel import far_level, list_buf
from sidm_tpu_torch.ops.fused_force import default_depth
from sidm_tpu_torch.ops.list_force import (compact_traces, max_displacement,
                                           record_lists)
from sidm_tpu_torch.ops.tree import build_octree
from sidm_tpu_torch.simulation import Simulation

torch.set_num_threads(2)

CM_PER_KPC = 3.085678e21
G_PER_1E10_MSUN = 1.989e43


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("sign", [1, -1])
def test_max_displacement_takes_the_minimum_image(axis, sign):
    box = 100.0
    ref = torch.full((4, 3), 50.0)
    ref[2, axis] = 99.9 if sign > 0 else 0.1
    pos = ref.clone()
    pos[2, axis] = (ref[2, axis] + sign * 0.3) % box    # wrapped
    pos[1] += 0.05                                      # an inner particle
    lists = types.SimpleNamespace(pos_ref=ref)
    plain = float(max_displacement(lists, pos))
    image = float(max_displacement(lists, pos, box))
    assert plain == pytest.approx(box - 0.3, rel=1e-5)
    assert image == pytest.approx(0.3, rel=1e-4)


def test_compact_traces_are_the_used_rows_traces():
    pos, _, mass = cosmo_ics(512, 3)
    n = len(mass)
    t = dict(pos=torch.tensor(pos, dtype=torch.float32),
             mass=torch.tensor(mass, dtype=torch.float32),
             eps=torch.full((n,), 10.0))
    tree = build_octree(t["pos"], t["mass"], t["eps"], t["mass"] > 0,
                        box=COSMO_BOX, depth=default_depth(n))
    lists = record_lists(tree, torch.zeros(n), torch.ones(n, dtype=bool),
                         theta=0.5, use_relative=False,
                         pbc=(COSMO_BOX, 0.001, 5000.0))
    tr = compact_traces(tree, lists)
    assert tr.shape == (lists.src.shape[0] + 1,)
    assert torch.equal(tr[:-1], tree.trq[lists.src.long()])
    assert float(tr[-1]) == 0.0 and float(tr.abs().max()) > 0


@pytest.mark.parametrize("record", [False, True])
def test_far_level_refuses_the_free_space_mode(record):
    """The free-space screened mode (a box of 0: PMVacuum, ROADMAP A, item
    11.2, once refused here) runs in either mode: cells beyond rcut + bmax
    of a group box are dropped, the rest classified as the open walk
    classifies them."""
    from sidm_tpu_torch.ops.far_kernel import C_FAR, C_OPEN, C_SEG
    from sidm_tpu_torch.ops.fused_force import classify

    ng, W = 2, 8
    rng = np.random.default_rng(3)
    rows = np.zeros((ng * W, 16), np.float32)
    rows[:, 0:3] = rng.uniform(-9, 9, (ng * W, 3))
    rows[:, 3] = 1.0
    rows[:, 4] = rng.choice([4, 40], ng * W)
    rows[:, 6] = rng.integers(0, 8, ng * W)
    rows[:, 7] = 8
    rows[:, 15] = 1.0
    rows = torch.tensor(rows)
    glo, ghi = torch.full((ng, 3), -1.0), torch.full((ng, 3), 1.0)
    pbc = (0.0, 0.1, 5.0)
    buf = list_buf(ng, 16, 16, "cpu") if record else None
    out = far_level(torch.arange(ng * W, dtype=torch.int32).reshape(ng, W),
                    torch.full((ng,), W, dtype=torch.int32), rows, ng * W,
                    torch.tensor(4.0), glo, ghi, torch.zeros(ng),
                    theta2=0.25, use_relative=False, leaf_cap=16, last=False,
                    Wn=8 * W, open_cap=W, big_cap=8, big_chunks=8, pbc=pbc,
                    lists=buf)
    planes = [classify(rows.reshape(ng, W, 16), glo, ghi, torch.zeros(ng),
                       torch.tensor(4.0), 0.25, False, 16, False, c)
              for c in (pbc, None)]
    far, seg, opn, _ = planes[0]
    assert out.cnt[C_FAR].tolist() == far.sum(1).tolist()
    assert out.cnt[C_SEG].tolist() == seg.sum(1).tolist()
    assert out.cnt[C_OPEN].tolist() == opn.sum(1).tolist()
    dx = torch.clamp(torch.maximum(glo[:, None] - rows.reshape(ng, W, 16)[
        ..., 0:3], rows.reshape(ng, W, 16)[..., 0:3] - ghi[:, None]), min=0)
    reach = torch.linalg.norm(dx, dim=-1) <= 5.0 + 1.0
    for a, b in zip(planes[0], planes[1]):
        assert torch.equal(a, b & reach)
    assert 0 < int(reach.sum()) < ng * W
    if record:
        assert buf.nf.tolist() == far.sum(1).tolist()


@pytest.mark.parametrize("field_sigma", [0.0, COSMO_FIELD_SIGMA])
def test_cosmo_ics_velocities_keep_positions(field_sigma):
    pos0, vel0, mass0 = cosmo_ics(4096, 5)
    pos, vel, mass = cosmo_ics(4096, 5, a_vel=0.1, field_sigma=field_sigma)
    assert np.array_equal(pos, pos0) and np.array_equal(mass, mass0)
    assert not vel0.any() and vel.any()


def test_cosmo_ics_clumps_at_their_virial_dispersion():
    n, a, G = 1 << 16, 0.1, 43007.1
    _, vel, mass = cosmo_ics(n, 7, a_vel=a)
    nc = int(n * 0.7) // 64
    m_clump = nc * mass[0]
    want = a * np.sqrt(G * m_clump / (6.0 * np.sqrt(np.pi) * a * 0.01
                                      * COSMO_BOX))
    assert np.std(vel[n - 64 * nc:]) == pytest.approx(want, rel=2e-2)


@pytest.mark.parametrize("field_sigma", [0.0, COSMO_FIELD_SIGMA])
def test_cosmo_ics_uniform_part(field_sigma):
    n, a = 1 << 14, 0.1
    _, vel, _ = cosmo_ics(n, 8, a_vel=a, field_sigma=field_sigma)
    uniform = vel[:n - 64 * (int(n * 0.7) // 64)]
    if field_sigma == 0.0:
        assert not uniform.any()
    else:
        assert np.std(uniform) == pytest.approx(a * field_sigma, rel=2e-2)


def test_cosmo_sidm_cross_section_is_one_cm2_per_g():
    cfg = cosmo_config(**COSMO_SIDM)
    u = set_units(cfg)
    h = cfg.HubbleParam
    # internal units: kpc/h and 1e10 Msun/h
    area_per_mass = u.CrossSectionInternal * (CM_PER_KPC / h) ** 2 / (
        G_PER_1E10_MSUN / h)
    assert area_per_mass == pytest.approx(1.0, rel=1e-6)
    assert cfg.CrossSectionType == 0 and cfg.ProbabilityTol == 0.2


@pytest.mark.parametrize("name,changes,n,phased", [
    ("cosmo-sidm", COSMO_SIDM, COSMO_N, True),
    ("cosmo-sidm-walk", COSMO_SIDM_WALK, COSMO_N, True),
    ("cosmo-veldisp", COSMO_VELDISP, COSMO_N, True),
    ("cosmo-small", COSMO_SIDM, COSMO_SMALL_N, False)])
def test_cosmo_configurations_construct(name, changes, n, phased):
    cfg = cosmo_config(n, **changes)
    sim = Simulation(cfg, device="cpu")
    assert sim.cfg.PeriodicBoundariesOn and sim.cfg.ComovingIntegrationOn
    assert bool(cfg.SIDMOn and cfg.CrossSection > 0) == (
        name != "cosmo-veldisp")
    assert cfg.VelDispOn == (name == "cosmo-veldisp")
    assert cfg.ListMode == (0 if name == "cosmo-sidm-walk" else 1)
    padded = -(-n // 256) * 256
    assert (padded >= Simulation.PHASE_THRESHOLD) == phased


def wrap_run(tmp_path, image: bool):
    """A physical periodic box on the cached lists (node drift) whose 8
    particles near x = box move out through the face: stepped until a
    list step in a cycle with a learned skin sees them wrapped (JAX's
    plain-difference monitor would end that cycle: ``wrap_records``)."""
    rng = np.random.default_rng(11)
    n, box = 512, 100.0
    pos = rng.uniform(0.0, box, (n, 3))
    vel = rng.normal(0.0, 0.5, (n, 3))
    pos[:8, 0] = box - 0.02
    vel[:8] = [2.0, 0.0, 0.0]
    cfg = SimConfig(
        PeriodicBoundariesOn=1, BoxSize=box, PMGrid=16,
        ComovingIntegrationOn=0, TimeBegin=0.0, TimeMax=10.0,
        MaxSizeTimestep=0.004, TypeOfTimestepCriterion=0,
        ErrTolIntAccuracy=0.025, ListMode=1, TreeRefreshSteps=4,
        ListNearCap=8192, TreeWalkEngine="wq", ForceMethod="tree", SIDMOn=0,
        SofteningHalo=0.5, SofteningHaloMaxPhys=0.5,
        GravityConstantInternal=1.0, OutputDir=str(tmp_path))
    sim = Simulation(cfg, mode="phased", device="cpu")
    sim.LIST_MONITOR_IMAGE = image
    sim.set_particles_from_arrays(pos, vel, np.full(n, 1e-3),
                                  np.ones(n, np.int32))
    sim.prepare()
    kinds = []
    for _ in range(14):
        w0 = sim.wrap_records
        sim.step()
        kinds.append((sim.last_list_info["kind"], sim.wrap_records - w0))
        if sim.wrap_records > w0:
            break
    assert sim.wrap_records == 1, kinds
    assert kinds[-1] == ("list", 1) and sim.last_list_info["skin"] > 0
    assert float(sim.particles.pos[:8, 0].max()) < 1.0, "not wrapped"
    return sim


def scaled(a, ref):
    """|a - ref| / max(|ref|, median |ref|) per particle
    (tests/test_pm.py's normalisation)."""
    n = torch.linalg.norm(ref.double(), dim=1)
    return torch.linalg.norm((a - ref).double(), dim=1) / torch.clamp(
        n, min=float(torch.quantile(n, 0.5)))


def test_wrap_ends_the_list_cycle_under_jax_rule(tmp_path):
    """JAX's monitor: the wrapped particles read ~BoxSize, the cycle ends
    and the next step records again."""
    sim = wrap_run(tmp_path, image=False)
    sim.step()
    assert sim.last_list_info["kind"] == "record"
    assert sim.last_list_info["skin"] > sim.cfg.BoxSize   # learned from it


def test_lists_stay_valid_after_a_wrap(tmp_path):
    """The minimum-image monitor (the default) keeps the cycle: the next
    step evaluates the same lists, the skin stays below the box, and the
    lists evaluated at the wrapped positions give the force of a fresh
    record there (skin 0) within tests/test_pm.py's TreePM bars (p99 <
    2.5e-3, max < 6e-3, against max(|a|, median |a|)), the wrapped
    particles included."""
    from sidm_tpu_torch.ops.list_force import advance_tree, eval_lists

    sim = wrap_run(tmp_path, image=True)
    lists = sim._lists_cache
    p = sim.particles
    mass = torch.where(p.valid, p.mass, torch.zeros_like(p.mass))
    eps = sim._softening()[torch.clamp(p.ptype, 0, 5).long()]
    pbc = sim._pbc()
    tree = advance_tree(sim._tree_cache, lists, p.pos,
                        torch.tensor(sim.time))
    acc, _ = eval_lists(tree, lists, mass, eps, need_pot=False, pbc=pbc)
    fresh = build_octree(p.pos, mass, eps, p.valid, box=sim.cfg.BoxSize,
                         depth=default_depth(p.n_padded))
    flists = record_lists(fresh, p.old_acc[fresh.perm], p.valid[fresh.perm],
                          theta=sim.cfg.ErrTolTheta,
                          use_relative=sim.cfg.TypeOfOpeningCriterion == 1,
                          err_tol_force_acc=sim.cfg.ErrTolForceAcc,
                          pbc=pbc)
    ref, _ = eval_lists(fresh, flists, mass, eps, need_pot=False, pbc=pbc)
    e = scaled(acc, ref)
    assert float(torch.quantile(e, 0.99)) < 2.5e-3
    assert float(e.max()) < 6e-3 and float(e[:8].max()) < 6e-3
    sim.step()
    assert sim.last_list_info["kind"] == "list"
    assert sim._lists_cache is lists
    assert sim.last_list_info["skin"] < 0.5 * sim.cfg.BoxSize
