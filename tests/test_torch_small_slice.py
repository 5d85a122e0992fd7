"""The port's single-program step (``Simulation._step_single``: the wq
walk or the direct sum, the hash-grid DSMC engine) against the JAX
``Simulation(mode="synchronized")`` at N = 2048 (below PHASE_THRESHOLD, so
both run their single-program step), ``HASH_CONFIG`` (flagship-dsmc's
SIDM settings, CrossSection raised as in tests/test_torch_sidm_slice.py),
prepare (``setup_smoothing_lengths``) + 4 steps, under ``ForceMethod tree``
and ``direct``, with JAX's trajectories frozen in
tests/data/torch_hash_golden.npz (the ``slow`` test reruns them).

The parity runs keep JAX's fixed cap of 96 rows a bucket
(``Simulation.HASH_CAP_GROWTH = False``), which drops rows for most of
this halo's queries, as JAX does. Held as in the other slice tests: the
scatter count of every step exactly, the neighbour counts exactly, time
and timesteps to rtol 1e-6, pos, vel, accel, pot, hsml_vd and dvel to 1e-4
of each array's largest magnitude, and the potential after the steps
(``compute_potential``, by ``ForceMethod``) to 1e-4 of its largest
magnitude. With growth (the default) the same run grows the cap to the
demand, drops nothing, and its kicks conserve momentum.

Besides: ``mode="fused"`` takes the single-program step at any N and
``"synchronized"`` the phased one from PHASE_THRESHOLD on, ``ForceMethod
direct`` is refused on the phased step and ``tree_legacy`` everywhere
(ROADMAP A, item 15). tests/test_torch_small_cli.py runs the command line
on this step.
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.diagnostics import compute_system_state
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import (HASH_CONFIG, HASH_GOLDEN, HASH_STEPS, N,
                                     SEED, flagship_ics,
                                     jax_hash_trajectories)

torch.set_num_threads(2)

RUNS = {"t": "tree", "d": "direct"}


def _run(tag, growth=False):
    pos, vel, mass = flagship_ics(N, SEED)
    sim = Simulation(SimConfig(**{**HASH_CONFIG, "ForceMethod": RUNS[tag]}),
                     mode="synchronized", device="cpu")
    sim.HASH_CAP_GROWTH = growth
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32))
    out, infos = {}, []

    def state(k, n_scat):
        prefix = f"{tag}{k}_"
        p = sim.particles
        s = compute_system_state(p)
        out[prefix + "time"] = sim.time
        for f in ("pos", "vel", "accel", "max_pred_time", "pot", "hsml_vd",
                  "ngb_vd", "dvel"):
            out[prefix + f] = getattr(p, f).numpy()
        out[prefix + "ekin"] = float(s.energy_kin)
        out[prefix + "epot"] = float(s.energy_pot)
        out[prefix + "n_scat"] = n_scat
        infos.append(dict(sim.last_sidm_info, masses=p.mass.clone()))

    sim.prepare()
    assert not sim._use_phased()
    state(0, 0)
    for k in range(1, HASH_STEPS + 1):
        _, _, n_scat = sim.step()
        state(k, n_scat)
    out[f"{tag}p_pot"] = sim.compute_potential().numpy()
    return out, infos, sim


@pytest.fixture(scope="module")
def runs():
    return {tag: _run(tag) for tag in RUNS}


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(HASH_GOLDEN))


@pytest.mark.parametrize("tag", list(RUNS))
def test_scatter_counts_match_jax(runs, golden, tag):
    out, infos, sim = runs[tag]
    got = [out[f"{tag}{k}_n_scat"] for k in range(HASH_STEPS + 1)]
    want = [int(golden[f"{tag}{k}_n_scat"]) for k in range(HASH_STEPS + 1)]
    print(f"{tag}: scatters per step {got}, cap {sim._hash_cap}, buckets "
          f"past it {[i['ngb_ovf'] for i in infos]}")
    assert got == want and sum(got) > 0
    assert all(i["engine"] == "hash" and i["cap"] == 96 for i in infos)
    assert sum(i["ngb_ovf"] for i in infos) > 0    # JAX's drops, counted


PREFIXES = [f"{tag}{k}_" for tag in RUNS for k in range(HASH_STEPS + 1)]


@pytest.mark.parametrize("prefix", PREFIXES)
def test_state_matches_jax(runs, golden, prefix):
    out = runs[prefix[0]][0]
    np.testing.assert_allclose(out[prefix + "time"], golden[prefix + "time"],
                               rtol=1e-6)
    np.testing.assert_allclose(out[prefix + "max_pred_time"],
                               golden[prefix + "max_pred_time"], rtol=1e-6)
    for f in ("pos", "vel", "accel", "pot", "hsml_vd", "dvel"):
        scale = max(float(np.abs(golden[prefix + f]).max()), 1e-30)
        err = float(np.abs(out[prefix + f] - golden[prefix + f]).max()) / scale
        assert err <= 1e-4, (f, err)
    flips = int(np.sum(out[prefix + "ngb_vd"] != golden[prefix + "ngb_vd"]))
    assert flips == 0


@pytest.mark.parametrize("tag", list(RUNS))
def test_potential_matches_jax(runs, golden, tag):
    out = runs[tag][0]
    valid = np.arange(out[f"{tag}p_pot"].shape[0]) < N
    want = golden[f"{tag}p_pot"][valid]
    err = float(np.abs(out[f"{tag}p_pot"][valid] - want).max())
    assert err <= 1e-4 * float(np.abs(want).max())


def test_grown_cap_drops_nothing():
    """With growth (the default) the cap grows to the demand in prepare
    and the steps drop no bucket row; the kicks conserve momentum."""
    out, infos, sim = _run("d", growth=True)
    print(f"cap {sim._hash_cap}, init {sim.last_hsml_init}, scatters "
          f"{[out[f'd{k}_n_scat'] for k in range(HASH_STEPS + 1)]}")
    assert sim._hash_cap > 96 and sim.last_hsml_init["ngb_ovf"] == 0
    assert all(i["ngb_ovf"] == 0 and i["lvl_clip"] == 0 for i in infos)
    for i in infos[1:]:
        m = i["masses"][:, None].double()
        kick = i["kick"].double()
        tot = float(torch.sum(m * torch.linalg.norm(kick, dim=1,
                                                    keepdim=True)))
        assert float(torch.linalg.norm(torch.sum(m * kick, 0))) <= 1e-5 * tot


def test_step_choice_and_refusals():
    cfg = SimConfig(**HASH_CONFIG)
    pos, vel, mass = flagship_ics(256, SEED)
    for mode, phased in (("synchronized", True), ("fused", False),
                         ("phased", True)):
        sim = Simulation(cfg, mode=mode, device="cpu")
        sim.PHASE_THRESHOLD = 256
        sim.set_particles_from_arrays(pos, vel, mass, np.ones(256, np.int32))
        assert sim._use_phased() == phased, mode
    with pytest.raises(NotImplementedError, match="item 15"):
        Simulation(SimConfig(**{**HASH_CONFIG, "ForceMethod": "direct"}),
                   mode="phased", device="cpu")
    sim = Simulation(SimConfig(**{**HASH_CONFIG, "ForceMethod": "direct"}),
                     device="cpu")
    sim.PHASE_THRESHOLD = 256
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(256, np.int32))
    with pytest.raises(NotImplementedError, match="item 15"):
        sim.step()
    with pytest.raises(NotImplementedError, match="item 15"):
        Simulation(SimConfig(**{**HASH_CONFIG,
                                "ForceMethod": "tree_legacy"}),
                   device="cpu")
    with pytest.raises(ValueError, match="mode"):
        Simulation(cfg, mode="adaptive", device="cpu")
    from sidm_tpu_torch.ops.direct import direct_sum
    with pytest.raises(NotImplementedError, match="item 11"):
        direct_sum(torch.zeros(4, 3), torch.ones(4), torch.ones(4), box=1.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("targets", [False, True])
def test_direct_kernel_matches_plain_on_card(cuda, targets):
    """H3 (csrc/direct.cu) against the plain sum on the N = 2048 halo with
    two softening lengths and 100 massless padding particles: p99.9
    relative error < 1e-5 on acc and pot, on all particles or a subset."""
    from sidm_tpu_torch.ops.direct import direct_gravity, direct_sum
    pos, _, mass = flagship_ics(N, SEED)
    n = N + 100
    pos_t = torch.zeros(n, 3)
    pos_t[:N] = torch.tensor(pos, dtype=torch.float32)
    mass_t = torch.zeros(n)
    mass_t[:N] = torch.tensor(mass, dtype=torch.float32)
    eps = torch.full((n,), 0.3)
    eps[:N:7] = 1.1
    pos_t, mass_t, eps = pos_t.to(cuda), mass_t.to(cuda), eps.to(cuda)
    tg = torch.arange(3, N, 5, device=cuda) if targets else None
    n0 = direct_sum.launches
    acc_k, pot_k = direct_sum(pos_t, mass_t, eps, targets=tg)
    assert direct_sum.launches == n0 + 1
    acc_p, pot_p = direct_gravity(pos_t, mass_t, eps, targets=tg)
    live = (torch.arange(n, device=cuda) if tg is None else tg) < N
    e = (torch.linalg.norm(acc_k - acc_p, dim=1)
         / torch.linalg.norm(acc_p, dim=1))[live]
    ep = (torch.abs(pot_k - pot_p) / torch.abs(pot_p))[live]
    assert float(torch.quantile(e, 0.999)) < 1e-5
    assert float(torch.quantile(ep, 0.999)) < 1e-5


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    live = jax_hash_trajectories()
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
