"""Both DSMC engines' scattering rates against the analytic sigma/m on the
CPU: the rate harness (``sidm_tpu_torch/validate_rate.py``, the port of
``scripts/validate_rate.py``) at N = 4096, hard sphere, 48 frozen passes
of each engine on one uniform periodic box (the harness's setup: BOX 1,
S_VEL 0.5, DesNumNgb 32, seed 2024, dt = 0.006 / (rho <sigma v>)).

Expected events: 0.5 N rho <sigma v> dt x 48 = 589.8; the Poisson error of
~585 events is sigma = 1/sqrt(585) = 4.1 %, so each engine is held to
|ratio - 1| < 3 sigma (~12 %; the harness's bar max(1 %, 3 sigma) is 3
sigma at this size), with no drop of any kind. The analytic <sigma v> is
the harness's quadrature, checked here against the closed form of the
hard sphere, <v_rel> = 2 sqrt(2/pi) sqrt(2) S_VEL. The N = 1e5 table of
all five types runs on the card (PERF.md).
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch import validate_rate as vr
from tests.make_torch_golden import HASH_GOLDEN, HASH_RATE

torch.set_num_threads(2)

N, PASSES = 4096, 48


def test_hard_sphere_quadrature_is_closed_form():
    a = np.sqrt(2.0) * vr.S_VEL
    np.testing.assert_allclose(vr.analytic_sigma_v(0, 1.0),
                               2.0 * a * np.sqrt(2.0 / np.pi), rtol=1e-6)


@pytest.fixture(scope="module")
def box():
    p0, tree, _ = vr.make_box(N, torch.device("cpu"))
    return p0, tree


@pytest.mark.parametrize("engine", ["walk", "lists"])
def test_rate_matches_analytic(box, engine):
    r = vr.run_type(*box, 0, engine, PASSES, N)
    print(f"{engine}: {r['events']} events, expected {r['expected']:.1f}, "
          f"ratio {r['ratio']:.4f} +- {r['err']:.4f}, drops {r['drops']}")
    assert r["events"] > 500
    assert abs(r["ratio"] - 1.0) < 3.0 * r["err"], r
    assert r["ok"] and not any(r["drops"].values()), r


def test_hash_engine_events_equal_jax():
    """The hash engine (``--engine hash``) from ``setup_smoothing_lengths``
    (``--hsml knn``, the JAX harness's start) on the same box: its three
    converging passes and 8 measured hard-sphere passes give JAX's
    ``sidm_scatter`` events pass by pass (tests/data/torch_hash_golden.npz,
    ``rate_``), with no bucket read past the cap (JAX's 96 holds this box's
    buckets) and no clipped level."""
    g = np.load(HASH_GOLDEN)
    n = HASH_RATE["n"]
    p0, tree, _ = vr.make_box(n, torch.device("cpu"), hsml="knn")
    r = vr.run_type(p0, tree, HASH_RATE["cs_type"], "hash",
                    HASH_RATE["passes"], n)
    print(f"hash: events per pass {r['per_pass']}, JAX "
          f"{g['rate_events'].tolist()}, drops {r['drops']}")
    assert r["per_pass"] == g["rate_events"].tolist()
    assert r["drops"] == dict(bucket=0, clip=0) and sum(r["per_pass"]) > 0
