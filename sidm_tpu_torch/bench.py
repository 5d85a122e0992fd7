"""bench.py's headline benchmark on the port: particle-steps/s for the
flagship SIDM run on one CUDA card.

What ``bench.py:26-94`` does, on ``sidm_tpu_torch``: the N = 1e6 NFW halo
(``ics.nfw(N, rho0=1.49e-4, rs=11.14356, G=43007.1, seed=12345)``) padded to
a multiple of 4096, ``prepare()``, 3 warm-up steps, then ``BENCH_STEPS``
timed steps closed by ``torch.cuda.synchronize()``; ``BENCH_N``,
``BENCH_STEPS`` (16) and ``BENCH_REFRESH`` (16, ``TreeRefreshSteps``) as
there. The configuration is bench.py's own (``bench_config``: SIDM on the
cached interaction lists, ``TreeRefreshSteps 16``, ``ListNearCap 5120``),
with one difference: ``TreeWalkEngine wq`` where bench.py leaves
``fused``, which the port does not run (ROADMAP.md A, item 15); on the
lists the engine only picks the fallback walk and ``compute_potential``.
The port's steps run phased at every N (``mode="phased"``; bench.py's
``synchronized`` is the same step at N >= 262144).

Prints ONE JSON line on stdout, as bench.py does:
  {"metric": "particle-steps/sec/chip", "value": ..., "unit": "1/s",
   "vs_baseline": ...}
and on stderr the card's name and power limit, the difference above, the
timed steps' kinds (record, list, walk) and DSMC engines, the records,
cap refits and walk fallbacks, ``sidm_trunc_frac`` and |dE/E| over the
timed steps (energies taken outside the timed window).

Run:  python3 -m sidm_tpu_torch.bench   (needs the CUDA card)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CPU_REFERENCE_PART_STEPS_PER_SEC = 1.5e5     # bench.py's baseline

N = int(os.environ.get("BENCH_N", 1_000_000))
STEPS = int(os.environ.get("BENCH_STEPS", 16))
REFRESH = int(os.environ.get("BENCH_REFRESH", 16))
WARMUP = 3


def bench_config(refresh: int = REFRESH):
    """bench.py:44-56 as a port configuration: flagship-dsmc at
    bench.py's cadence and near cap."""
    from .flagship import DSMC, flagship_config
    return flagship_config(**DSMC, TreeRefreshSteps=refresh,
                           ListNearCap=5120)


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def _energy(sim) -> float:
    from .diagnostics import compute_system_state
    sim.compute_potential()
    s = compute_system_state(sim.particles)
    return float(s.energy_kin + s.energy_pot)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA card; the benchmark runs on the "
                         "card only")
    from .flagship import flagship_ics
    from .simulation import Simulation

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log(f"# card: {card}")
    _log("# config: bench.py:44-56 (SIDMOn 1, ListMode 1, TreeRefreshSteps "
         f"{REFRESH}, ListNearCap 5120); differs in TreeWalkEngine wq "
         "(bench.py: fused)")
    t0 = time.time()
    pos, vel, mass = flagship_ics(N, 12345)
    sim = Simulation(bench_config(), mode="phased")
    sim.set_particles_from_arrays(pos, vel, mass, np.ones(N, np.int32),
                                  pad_to_multiple=4096)
    _log(f"# ICs+setup: {time.time() - t0:.1f}s")
    t0 = time.time()
    sim.prepare()
    torch.cuda.synchronize()
    _log(f"# prepare (hsml init, first force, build): "
         f"{time.time() - t0:.1f}s")
    t0 = time.time()
    for _ in range(WARMUP):
        sim.step()
    torch.cuda.synchronize()
    _log(f"# warmup steps: {time.time() - t0:.1f}s")

    e0 = _energy(sim)
    torch.cuda.synchronize()
    kinds, engines, records = [], [], 0
    list_refits, sidm_refits = sim._list_refits, sim._sidm_refits
    t0 = time.time()
    for _ in range(STEPS):
        sim.step()
        li, si = sim.last_list_info, sim.last_sidm_info or {}
        kinds.append(li["kind"] if li else "walk")
        engines.append(si.get("engine"))
        records += bool(si.get("record"))
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    e1 = _energy(sim)
    de = abs(e1 - e0) / abs(e0)
    walk = sum(k == "walk" for k in kinds)
    _log(f"# {STEPS} steps: {elapsed:.3f}s ({elapsed / STEPS:.4f}s/step) "
         f"[{card}]")
    _log(f"# step kinds {kinds}; DSMC engines {engines}; candidate records "
         f"{records}; list cap refits {sim._list_refits - list_refits}, "
         f"candidate cap refits {sim._sidm_refits - sidm_refits}; force walk "
         f"steps {walk}, DSMC walk steps "
         f"{sum(e == 'walk' for e in engines)}; sidm_trunc_frac "
         f"{sim.sidm_trunc_frac:.3e} ({sim.sidm_trunc_targets} targets at "
         f"K); E {e0:.9g} -> {e1:.9g}, |dE/E| {de:.3e}; t = "
         f"{sim.time:.6g}")
    value = N * STEPS / elapsed
    print(json.dumps({
        "metric": "particle-steps/sec/chip",
        "value": round(value, 1),
        "unit": "1/s",
        "vs_baseline": round(value / CPU_REFERENCE_PART_STEPS_PER_SEC, 2),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
