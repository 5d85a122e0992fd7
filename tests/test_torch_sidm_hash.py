"""The port's hash-grid DSMC engine (``sidm_tpu_torch/ops/sidm.py``:
``sidm_scatter``, ``update_hsml``, ``hash_scan``, ``resolve_conflicts``)
against the JAX package's ``sidm_tpu/ops/sidm.py`` with JAX's outputs
frozen in tests/data/torch_hash_golden.npz (``python -m
tests.make_torch_golden hash``; the ``slow`` test reruns them).

``sidm_scatter`` on the N = 4000 NFW halo padded to 4096 (smoothing lengths
from ``setup_smoothing_lengths``, 64 particles with a pending kick, t =
0.05 from 0, all active, JAX's fixed cap 96) for cross-section types 0-4:
the gate equal; the scan's partners and hits equal to JAX's except at
near-ties (a uniform within TIE relative of a running sum: the port's
cumsum adds in another order than JAX's; counted, and none occurs here);
the scatter count equal, hsml_vd to 1e-6 relative, ngb_vd equal and dvel
to 1e-5 of its largest magnitude; the kicks conserve momentum. JAX's fixed
cap truncates buckets for most of this halo's queries: the port counts
them (``ngb_ovf``), and at the cap grown to the demand counts none.
``resolve_conflicts`` (the compact rounds over every proposer) gives JAX's
uncapped ``_resolve_conflicts`` accepted set on random proposals, as
JAX's own test_conflict_resolver_compact_equivalence holds its two.

On the card (``gpu``): H2 (``csrc/hash_scan.cu``) against the plain
version (partners equal except near-ties, need, clip and rows read equal)
at caps 96 and grown.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sidm_tpu_torch.ops import neighbors as tn
from sidm_tpu_torch.ops import sidm as ts
from sidm_tpu_torch.rng import particle_uniforms, run_key, step_key
from sidm_tpu_torch.state import make_particles
from tests.make_torch_golden import (HASH, HASH_GOLDEN, HASH_RESOLVE,
                                     HASH_SCATTER, hash_particles,
                                     hash_pending, hash_proposals,
                                     jax_hash_ops)

torch.set_num_threads(2)

TIE = 1e-4      # relative gap of a uniform to a running sum: a near-tie


def _params(cs):
    return ts.SidmParams(HASH_SCATTER["sigma"], cs, 300.0, 100.0, -1.5,
                         HASH["k"], 2, False, 0.1, 0.0, 0.0)


def _inputs(device="cpu"):
    p = hash_particles(make_particles)
    p = tn.setup_smoothing_lengths(p, HASH["k"], 2)
    p = dataclasses.replace(p, dvel=torch.tensor(hash_pending(
        p.pos.shape[0])))
    p = dataclasses.replace(p, **{f.name: getattr(p, f.name).to(device)
                                  for f in dataclasses.fields(p)})
    vmax = torch.sqrt(torch.max(torch.sum(p.vel ** 2, -1)))
    t = torch.tensor(HASH_SCATTER["time"], device=device)
    key = step_key(run_key(55, 497527), HASH_SCATTER["step"])
    return p, t, vmax, key


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(HASH_GOLDEN))


@pytest.fixture(scope="module")
def passes():
    p, t, vmax, key = _inputs()
    return {cs: ts.sidm_scatter(p, p.pos, t, p.valid, vmax, key,
                                _params(cs), return_info=True)
            for cs in range(5)}, p


@pytest.mark.parametrize("cs", range(5))
def test_sidm_scatter_equal_jax(golden, passes, cs):
    (q, n_scat, info), p = passes[0][cs], passes[1]
    scan = info["scan"]
    gate = np.zeros(p.pos.shape[0], bool)
    gate[info["tid"].numpy()] = True
    np.testing.assert_array_equal(gate, golden[f"s{cs}_gate"])
    diff = ((scan.partner.numpy() != golden[f"s{cs}_partner"])
            | (scan.hit.numpy() != golden[f"s{cs}_hit"]))
    ties = diff & (scan.margin.numpy() < TIE)
    print(f"type {cs}: {int(n_scat)} scatters of {info['n_gated']} gated, "
          f"{int(diff.sum())} partner differences ({int(ties.sum())} "
          f"near-ties), buckets past cap {int(info['ngb_ovf'])}")
    assert int(diff.sum()) == int(ties.sum()) == 0
    assert int(n_scat) == int(golden[f"s{cs}_nscat"]) > 0
    h = golden[f"s{cs}_hsml"]
    assert float(np.max(np.abs(q.hsml_vd.numpy() - h)
                        / np.maximum(h, 1e-30))) <= 1e-6
    np.testing.assert_array_equal(q.ngb_vd.numpy(), golden[f"s{cs}_ngb"])
    dv = golden[f"s{cs}_dvel"]
    assert float(np.abs(q.dvel.numpy() - dv).max()) <= 1e-5 * float(
        np.abs(dv).max())
    m = p.mass[:, None].double()
    kick = info["kick"].double()
    assert float(torch.linalg.norm(torch.sum(m * kick, 0))) <= 1e-5 * float(
        torch.sum(m * torch.linalg.norm(kick, dim=1, keepdim=True)))


def test_fixed_cap_counts_drops_grown_cap_has_none(passes):
    """JAX's cap 96 truncates buckets here (counted: the queries and
    targets whose need passes it); at the cap grown to the need nothing
    drops, and the grown pass reads every row of its buckets."""
    (_, _, info), p = passes[0][0], passes[1]
    knn, scan, tid = info["knn"], info["scan"], info["tid"]
    upd = p.is_collisionless & p.valid
    want = int(torch.sum(upd & (knn.need > 96))) + int(
        torch.sum(scan.need[tid] > 96))
    assert int(info["ngb_ovf"]) == want > 0
    p2, t, vmax, key = _inputs()
    cap = -(-int(info["need"]) // 32) * 32
    _, ns, info2 = ts.sidm_scatter(p2, p2.pos, t, p2.valid, vmax, key,
                                   _params(0), cap=cap, return_info=True)
    print(f"need {int(info['need'])}: cap {cap}, scatters {int(ns)}, need "
          f"then {int(info2['need'])}")
    if int(info2["need"]) <= cap:
        assert int(info2["ngb_ovf"]) == 0
    assert int(info2["lvl_clip"]) == int(info["lvl_clip"]) == 0


@pytest.mark.parametrize("k", range(len(HASH_RESOLVE)))
def test_resolver_equals_jax_uncapped(golden, k):
    prop = torch.tensor(hash_proposals(HASH_RESOLVE[k])).long()
    acc, rounds, dropped, _, _ = ts.resolve_conflicts(prop, prop.numel())
    np.testing.assert_array_equal(acc.numpy(), golden[f"r{k}_acc"])
    assert dropped == 0 and (rounds > 0) == bool((prop >= 0).any())
    acc_c = ts.resolve_conflicts_compact(prop, prop.numel())[0]
    assert torch.equal(acc, acc_c)


def test_scan_zero_uniform_crosses_at_slot_zero():
    """A uniform of 0 crosses at JAX's slot 0 (cum >= rand holds there
    whatever the candidate), as jnp.argmax of the crossing mask gives."""
    p, t, vmax, key = _inputs()
    n = p.pos.shape[0]
    s0 = ts.hash_base_cell(p, p.pos, _params(0))
    table = tn.build_table(p.pos, p.ptype, p.valid, s0=s0, n_levels=12,
                           payload=tn.make_payload(p.pos, p.vel, p.mass,
                                                   p.ptype))
    rand = particle_uniforms(key, p.pid, 1)[:, 0].contiguous()
    tid = torch.arange(0, n, 97)
    rand[tid[:5]] = 0.0
    dts = torch.full((n,), 0.01)
    sc = ts.hash_scan_plain(table, p.pos, p.vel, p.hsml_vd, p.ptype, rand,
                            dts, tid, t, torch.tensor(1e4), _params(0), 96)
    idx, _, _, _ = tn.gather_candidates(table, p.pos[tid[:5]],
                                        p.ptype[tid[:5]], p.hsml_vd[tid[:5]],
                                        cap=96)
    assert torch.equal(sc.partner[tid[:5]].long(), idx[:, 0].long())
    assert bool(sc.hit[tid[:5]].all())


def test_bounds_count_tiny_input_by_hand():
    """bounds.knn_work, scan_work and direct_work on five particles at
    known cells (s0 = 1): the query (particle 1, h = 0.9, level 0, cell
    (0, 0, 0)) reaches three non-empty buckets holding particles {0, 1},
    {2} and {3} (particle 4 is outside its stencil): 4 rows; one valid
    pair (particle 0 at r = 0.866); no crossing (uniform 1)."""
    from sidm_tpu_torch import bounds
    pos = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [1.5, 0.5, 0.5],
                        [1.5, 1.5, 0.5], [5.5, 5.5, 5.5]])
    n = pos.shape[0]
    ptype = torch.ones(n, dtype=torch.int32)
    table = tn.build_table(pos, ptype, ptype >= 0, s0=1.0, n_levels=2,
                           payload=tn.make_payload(pos, torch.zeros_like(pos),
                                                   torch.ones(n), ptype))
    keys = []
    q = torch.tensor([1])
    r = tn.knn_radius_plain(table, pos[q], ptype[q], torch.tensor([0.9]), 2,
                            cap=96, n_iter=1, keys=keys)
    assert int(r.scanned[0]) == 4
    ops, nb = bounds.knn_work(table, keys, r.scanned, 1, 96)
    assert (ops, nb) == (11 * 4, 8 * 3 + 16 * 4 + 44)
    keys = []
    sc = ts.hash_scan_plain(table, pos, torch.zeros_like(pos),
                            torch.full((n,), 0.9), ptype, torch.ones(n),
                            torch.ones(n), q, torch.tensor(1.0),
                            torch.tensor(1.0), _params(0), 96, keys=keys)
    assert int(sc.scanned[1]) == 4 and int(sc.ok[1]) == 1
    ops, nb = bounds.scan_work(table, keys, sc.scanned, sc.ok, q, 96)
    assert (ops, nb) == (16 * 4 + 26 * 1, 8 * 3 + 36 * 4 + 64)
    assert bounds.direct_work(5, 2, True) == (25 * 10, 20 * 5 + 4 * 2 + 32)
    assert bounds.direct_work(5, 2, False) == (22 * 10, 20 * 5 + 4 * 2 + 24)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("grown", [False, True])
@pytest.mark.parametrize("cs", [0, 2])
def test_scan_kernel_matches_plain_on_card(cuda, cs, grown):
    p, t, vmax, key = _inputs(cuda)
    params = _params(cs)
    _, _, info = ts.sidm_scatter(p, p.pos, t, p.valid, vmax, key, params,
                                 return_info=True)
    cap = -(-int(info["need"]) // 32) * 32 if grown else 96
    n = p.pos.shape[0]
    s0 = ts.hash_base_cell(p, p.pos, params)
    table = tn.build_table(p.pos, p.ptype, p.valid, s0=s0, n_levels=12,
                           payload=tn.make_payload(p.pos, p.vel, p.mass,
                                                   p.ptype))
    rand = particle_uniforms(key, p.pid, 1)[:, 0].contiguous()
    tid = torch.arange(0, n, 3, device=cuda)
    rand[tid[:3]] = 0.0
    dts = torch.full((n,), 0.02, device=cuda)
    args = (table, p.pos, p.vel, p.hsml_vd, p.ptype, rand, dts, tid, t,
            torch.tensor(1e4, device=cuda), params, cap)
    n0 = ts.hash_scan.launches
    k = ts.hash_scan(*args)
    assert ts.hash_scan.launches == n0 + 1
    pl = ts.hash_scan_plain(*args)
    diff = (k.partner != pl.partner) | (k.hit != pl.hit)
    assert bool(torch.all(pl.margin[diff] < TIE))
    for f in ("need", "clip"):
        assert torch.equal(getattr(k, f), getattr(pl, f).to(
            getattr(k, f).dtype)), f
    same = ~diff
    assert torch.equal(k.scanned[same], pl.scanned[same])
    assert int(k.hit.sum()) > 0


@pytest.mark.slow
def test_golden_is_current_jax_output(golden):
    live = jax_hash_ops()
    for k, v in live.items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
