"""Shared pieces of tests/test_torch_cosmo_dsmc_{lists,walk,hash}.py: DSMC
in periodic and comoving runs (ROADMAP A, item 11.4) through the port's
Simulation on the CPU, held to the JAX states frozen in
tests/data/torch_cosmo_sidm_golden.npz (``d{v}{e}{k}_``).

The run is cosmo-sidm (``flagship.COSMO_SIDM``) on its field at N = 512
with mesh 32 and CrossSection raised 1e4x (tests/make_torch_golden.py
``CSIDM``, ``csidm_config``), in the box without comoving integration
(``b``), comoving without the box (``c``) and both (``x``), with
``ScatterLog 1``; prepare + CSIDM["steps"] steps. Held after every step:

* bit-equal: the step's scatter count, every particle's neighbour count
  ``ngb_vd`` (the gated targets' hits: each gated target's count is
  rewritten by the pass), and the scatter log's partners (each event's
  time and particle ids);
* time and timesteps (``max_pred_time``) to rtol 1e-6; positions to 1e-6
  of the box (the minimum image of the difference in a box);
* velocities, accelerations and the pending kicks ``dvel`` to 2e-3 of
  each array's largest magnitude (tests/torch_cosmo_checks.py's bar for
  the TreePM box: the screened pairs' erfc and exp and the mesh's FFTs in
  torch and in XLA, summed in another order); ``hsml_vd`` to 1e-4 of its
  largest.

Besides, the run gated DSMC targets and scattered, every step on the
engine asked for, and the kicks conserve momentum. The hash engine keeps
JAX's 96 rows a bucket (``Simulation.HASH_CAP_GROWTH = False``, ROADMAP
C.13) and the list monitors JAX's plain displacement
(``Simulation.LIST_MONITOR_IMAGE = False``, C.20). JAX's DSMC walk runs on ``TreeWalkEngine fused`` (its ``wq``
branch raises NameError, ROADMAP C.9); the port's walk engine is its own.
"""

import os

import numpy as np
import torch

from sidm_tpu_torch.config import SimConfig
from sidm_tpu_torch.simulation import Simulation
from tests.make_torch_golden import (COSMO_SIDM_GOLDEN, CSIDM, CSIDM_ENGINES,
                                     CSIDM_VARIANTS, csidm_config,
                                     csidm_field)

VARIANTS = list(CSIDM_VARIANTS)
FIELDS = ("pos", "vel", "accel", "max_pred_time", "hsml_vd", "ngb_vd",
          "dvel")


def load_golden(engine: str) -> dict:
    with np.load(COSMO_SIDM_GOLDEN) as z:
        return {k: z[k] for k in z.files if k.startswith("d")
                and k[2] == engine}


def run_port(tmp, variant: str, engine: str):
    """The port's run: per step (0 = prepare) its state, scatter count
    and ``last_sidm_info``; the scatter log's records."""
    mode, changes = CSIDM_ENGINES[engine]
    cfg = csidm_config(variant, engine, OutputDir=str(tmp), ScatterLog=1,
                       TreeWalkEngine="wq")
    sim = Simulation(SimConfig(**cfg), mode=mode, device="cpu")
    sim.HASH_CAP_GROWTH = False
    sim.LIST_MONITOR_IMAGE = False
    n = CSIDM["n"]
    pos, vel, mass = csidm_field()
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(n, np.int32))
    states = []

    def state(n_scat):
        p = sim.particles
        states.append(dict({f: getattr(p, f).numpy().copy() for f in FIELDS},
                           time=sim.time, n_scat=n_scat,
                           info=dict(sim.last_sidm_info or {},
                                     masses=p.mass.clone())))

    sim.prepare()
    state(0)
    for _ in range(CSIDM["steps"]):
        _, _, n_scat = sim.step()
        state(n_scat)
    path = os.path.join(str(tmp), "sct_000.0")
    sct = (np.fromfile(path, np.float32).reshape(-1, 20)
           if os.path.exists(path) else np.zeros((0, 20), np.float32))
    return sim, states, sct


def events(sct):
    """The scatter log's (time bits, id1, id2) per event, sorted."""
    bits = sct.view(np.int32)
    return sorted(zip(bits[:, 0].tolist(), bits[:, 1].tolist(),
                      bits[:, 2].tolist()))


def check_against_jax(sim, states, sct, golden, tag, engine):
    box = sim.cfg.BoxSize if sim.cfg.PeriodicBoundariesOn else 0.0
    scat, gated = [], []
    for k, s in enumerate(states):
        pre = f"{tag}{k}_"
        t = float(golden[pre + "time"])
        assert abs(s["time"] - t) <= 1e-6 * abs(t), (pre, s["time"], t)
        np.testing.assert_allclose(s["max_pred_time"],
                                   golden[pre + "max_pred_time"], rtol=1e-6)
        d = np.abs(s["pos"] - golden[pre + "pos"])
        if box:
            d = np.minimum(d, box - d)
        assert d.max() <= 1e-6 * sim.cfg.BoxSize, (pre, d.max())
        np.testing.assert_array_equal(s["ngb_vd"], golden[pre + "ngb_vd"],
                                      pre)
        for f, tol in (("vel", 2e-3), ("accel", 2e-3), ("dvel", 2e-3),
                       ("hsml_vd", 1e-4)):
            want = golden[pre + f]
            err = np.abs(s[f] - want).max()
            assert err <= tol * max(np.abs(want).max(), 1e-30), (pre, f, err)
        if k:
            assert s["n_scat"] == int(golden[pre + "n_scat"]), pre
            scat.append(s["n_scat"])
            info = s["info"]
            assert info["engine"] == {"l": "lists", "w": "walk",
                                      "h": "hash"}[engine], info["engine"]
            gated.append(int(info["n_gated"]))
            if not gated[-1]:
                continue
            m = info["masses"][:, None].double()
            kick = info["kick"].double()
            tot = float(torch.sum(m * torch.linalg.norm(kick, dim=1,
                                                        keepdim=True)))
            assert float(torch.linalg.norm(torch.sum(m * kick, 0))) \
                <= 1e-5 * tot + 1e-30
    assert sum(scat) > 0 and sum(gated) > 0, (scat, gated)
    assert len(sct) == sum(scat)
    assert events(sct) == events(golden[f"{tag}_sct"])
