"""Scattering-rate validation against the analytic sigma/m, on the card.

The port of ``scripts/validate_rate.py``: a uniform periodic box (the
kernel density estimate is unbiased for a Poisson point set) with
Maxwellian velocities, a frozen configuration, and many independent DSMC
passes. The expected pair rate per pass for cross-section type t is

    E[n_scat] = 0.5 N rho <sigma_t(v_rel) v_rel> dt

with rho = N m / V the mass density (CrossSectionInternal is sigma/m) and
the average over the Maxwell distribution of v_rel (per-axis variance
2 S_VEL^2); the type-4 angular rejection integrates to sigma0/(1+beta^2).
The bar is the reference harness's: |ratio - 1| < max(1 %, 3 sigma), with
sigma the Poisson error 1/sqrt(events).

Setup as in the JAX harness: BOX 1, S_VEL 0.5, VC 1, VSCALE 1.2, ALPHA
-0.6, DesNumNgb 32, seed 2024, dt = 0.006 / (rho <sigma v>) (about 0.3 %
of N events per pass, so that the one-scatter-per-particle conflict loss
stays well under the bar), passes keyed ``step_key(run_key(7, t), i)``
with salt i. Three engines:

* ``walk``: ``sidm_scatter_fused(box=)``, the range walk and the segment
  pass (JAX's harness runs this engine);
* ``lists``: the candidate lists recorded once at skin 0
  (``record_candidates_from_particles(box=)``) and ``sidm_scatter_lists
  (box=)`` on every pass;
* ``hash``: the hash-grid engine of the single-program step,
  ``sidm_scatter(box=)`` (its hsml refresh, H1, and its scan, H2), with
  its rows per bucket grown to the demand as ``Simulation`` grows them.

The smoothing lengths start from ``tree_hsml_init_fused(box=)`` (``--hsml
tree``, the default) or from the hash engine's ``setup_smoothing_lengths
(box=)``: at JAX's fixed 96 rows a bucket (``--hsml knn``, the JAX
harness's start, which truncates the coarse levels' buckets) or with the
rows grown to the demand as ``Simulation`` grows them (``--hsml
knn-grown``). Then every engine takes
three passes of its own hsml controller (which gate every target: the list
engine runs with gated and tail capacities that hold them all, as
``Simulation`` grows its capacities after a drop; the hash engine refreshes
its lengths every pass). Per type and engine the harness also prints what
the engine dropped, summed over the controller's and the measured passes:
the walk's cells past its caps, overfull-cell particles and segment drops;
the lists' segment drops, candidates truncated at K, and gated and tail
target drops; the hash engine's buckets read past its cap (0 after its
growth) and clipped levels. A drop is a rate biased low.

Run:  python3 -m sidm_tpu_torch.validate_rate [N] [passes]
          [--engine walk|lists|hash|both] [--hsml tree|knn|knn-grown]
          [--device cuda|cpu] [types...]
Defaults N = 1e5, 256 passes, the walk and list engines (``both``), the
tree start, all five types, the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List

import numpy as np
import torch

BOX = 1.0
S_VEL = 0.5            # per-axis velocity dispersion
VC = 1.0               # yukawa velocity scale
VSCALE = 1.2           # power-law velocity scale
ALPHA = -0.6           # power-law exponent (reference bounds need <= 0)
DES_NGB = 32
SEED = 2024
EVENT_FRACTION = 0.006  # dt = EVENT_FRACTION / (rho <sigma v>)


def analytic_sigma_v(cs_type: int, sigma0: float) -> float:
    """<sigma(v) v> over the Maxwell distribution of v_rel (per-axis
    variance 2 S_VEL^2) by quadrature."""
    a = np.sqrt(2.0) * S_VEL            # Maxwell parameter of v_rel
    v = np.linspace(1e-6, 30 * a, 400_000)
    pdf = np.sqrt(2 / np.pi) * v ** 2 / a ** 3 * np.exp(-v ** 2 / (2 * a ** 2))
    pdf /= np.trapezoid(pdf, v)
    if cs_type == 0:
        sv = sigma0 * v
    elif cs_type == 1:
        sv = sigma0 * np.ones_like(v)
    elif cs_type == 2:
        sv = sigma0 * v / (1 + (v / VC) ** 2) ** 2
    elif cs_type == 3:
        sv = sigma0 * v * (v / VSCALE) ** ALPHA
    elif cs_type == 4:
        # dsigma/dOmega = sigma0/4pi/(1+beta^2 sin^2(th/2))^2 integrates
        # to sigma0/(1+beta^2)
        sv = sigma0 * v / (1 + (v / VC) ** 2)
    else:
        raise ValueError(cs_type)
    return float(np.trapezoid(sv * pdf, v))


def rate_params(cs_type: int):
    """SidmParams of one cross-section type (sigma0 = 1)."""
    from .ops.sidm import SidmParams
    return SidmParams(
        cross_section_internal=1.0, cross_section_type=cs_type,
        yukawa_velocity=VC, cross_section_vel_scale=VSCALE,
        cross_section_pow_law=ALPHA, des_num_ngb=DES_NGB, max_num_ngb_dev=2,
        comoving=False, hubble=1.0, omega0=0.0, omega_lambda=0.0)


def make_box(n: int, device, hsml: str = "tree"):
    """The uniform periodic box: (particles with initial smoothing
    lengths, by ``tree_hsml_init_fused`` or, ``hsml="knn"``,
    ``setup_smoothing_lengths`` at JAX's cap of 96 rows a bucket
    (``"knn-grown"``: the cap grown to the demand); tree on the box,
    vmax)."""
    from .ops.fused_force import default_depth
    from .ops.fused_range import tree_hsml_init_fused
    from .ops.tree import build_octree
    from .state import make_particles

    rng = np.random.default_rng(SEED)
    pos = rng.uniform(0, BOX, (n, 3))
    vel = rng.normal(0, S_VEL, (n, 3))
    p = make_particles(pos, vel, np.full(n, 1.0 / n), np.ones(n, np.int32),
                       pad_to_multiple=4096, device=device)
    npad = p.pos.shape[0]
    mass = torch.where(p.valid, p.mass, torch.zeros_like(p.mass))
    tree = build_octree(p.pos, mass, torch.full_like(mass, 0.01), p.valid,
                        box=BOX, depth=default_depth(npad))
    if hsml.startswith("knn"):
        from .ops.neighbors import setup_smoothing_lengths
        cap = 96
        while True:
            q, r = setup_smoothing_lengths(p, DES_NGB, 2, box=BOX, cap=cap,
                                           return_info=True)
            need = int(torch.max(r.need))
            if hsml == "knn" or need <= cap:
                break
            cap = -(-need // 32) * 32
        p = q
    else:
        p = tree_hsml_init_fused(p, tree, DES_NGB, box=BOX)
    vmax = torch.sqrt(torch.max(torch.sum(p.vel ** 2, -1)))
    return p, tree, vmax


class _Engine:
    """One DSMC pass of an engine on the frozen box, with its drops."""

    def __init__(self, name: str, tree, params):
        from .ops.list_range import RangeListConfig
        self.name, self.tree, self.params = name, tree, params
        self.cands = None
        self.drops = [0, 0, 0]       # walk: cells, big, seg
        self.cand_ovf = [0, 0]       # lists: segments, K
        self.gated_ovf = [0, 0]      # lists: gated, tail targets
        self.hash_ovf = [0, 0]       # hash: buckets past cap, clipped
        self.cap = 96                # hash: rows per bucket, grown
        # gated and tail capacities that hold every target: the hsml
        # controller's passes gate them all (Simulation grows its
        # capacities to this after a drop)
        n = tree.pos_s.shape[0]
        self.rcfg = RangeListConfig(gated_frac=1.0, tail_cap=n)

    def record(self, p):
        from .ops.list_range import record_candidates_from_particles
        self.cands = record_candidates_from_particles(
            p, p.pos, self.tree, skin=0.0, params=self.params, box=BOX,
            rcfg=self.rcfg)
        self.cand_ovf = [a + int(b) for a, b in
                         zip(self.cand_ovf, self.cands.ovf.tolist())]

    def run(self, p, key, salt: int, tm: float):
        """(particles after the pass, scatters); its drops added up."""
        from .ops.fused_range import sidm_scatter_fused
        from .ops.list_range import sidm_scatter_lists
        dev = p.pos.device
        t = torch.tensor(tm, dtype=p.pos.dtype, device=dev)
        active = p.valid.clone()
        vmax = torch.sqrt(torch.max(torch.sum(p.vel ** 2, -1)))
        if self.name == "hash":
            from .ops.sidm import sidm_scatter
            while True:
                q, ns, info = sidm_scatter(
                    p, p.pos, t, active, vmax, key, self.params, box=BOX,
                    cap=self.cap, return_info=True)
                need, ovf, clip = (int(x) for x in torch.stack([
                    info["need"], info["ngb_ovf"], info["lvl_clip"]]).tolist())
                if need <= self.cap:
                    break
                self.cap = -(-need // 32) * 32
            self.hash_ovf = [self.hash_ovf[0] + ovf, self.hash_ovf[1] + clip]
            return q, int(ns)
        if self.name == "walk":
            q, ns, info = sidm_scatter_fused(
                p, p.pos, self.tree, t, active, vmax, key, self.params,
                salt=salt, box=BOX, return_info=True)
            d = [int(info[k]) for k in ("ovf_walk", "ovf_big", "ovf_seg")]
            self.drops = [a + b for a, b in zip(self.drops, d)]
            return q, int(ns)
        q, ns, _, ovf_g, _ = sidm_scatter_lists(
            p, p.pos, self.tree, self.cands, t, active, vmax, key,
            self.params, rcfg=self.rcfg, salt=salt, box=BOX)
        self.gated_ovf = [a + int(b) for a, b in
                          zip(self.gated_ovf, ovf_g.tolist())]
        return q, int(ns)

    def converge(self, p, passes: int = 3):
        """The engine's own hsml controller on the box, ``passes`` times
        (every target scanned: dt = 2 at t = 1)."""
        from .rng import run_key
        for i in range(passes):
            if self.name == "lists":
                self.record(p)
            q, _ = self.run(p, run_key(1, i), 900 + i, 1.0)
            p = dataclasses.replace(p, hsml_vd=q.hsml_vd, ngb_vd=q.ngb_vd)
        return p


def run_type(p0, tree, cs_type: int, engine: str, passes: int,
             n: int) -> dict:
    """``passes`` frozen passes of one engine for one type: events,
    expectation, ratio, its Poisson error, the verdict and the drops."""
    from .rng import run_key, step_key
    params = rate_params(cs_type)
    sv0 = analytic_sigma_v(cs_type, 1.0)
    rho = 1.0 / BOX ** 3                 # total mass 1 in the box
    dt = EVENT_FRACTION / (rho * sv0)
    eng = _Engine(engine, tree, params)
    p = eng.converge(p0)
    tm = 1.0
    p = dataclasses.replace(p, current_time=torch.full_like(
        p.current_time, tm - dt / 2))
    if engine == "lists":
        eng.record(p)
    t0 = time.perf_counter()
    per_pass = []
    for i in range(passes):
        _, ns = eng.run(p, step_key(run_key(7, cs_type), i), i, tm)
        per_pass.append(ns)
    tot = sum(per_pass)
    el = time.perf_counter() - t0
    expect = 0.5 * n * rho * sv0 * dt * passes
    ratio = tot / expect
    err = 1.0 / np.sqrt(max(tot, 1))
    if engine == "walk":
        drops = dict(cells=eng.drops[0], big=eng.drops[1], seg=eng.drops[2])
    elif engine == "hash":
        drops = dict(bucket=eng.hash_ovf[0], clip=eng.hash_ovf[1])
    else:
        drops = dict(seg=eng.cand_ovf[0], k_trunc=eng.cand_ovf[1],
                     gated=eng.gated_ovf[0], tail=eng.gated_ovf[1])
    return dict(type=cs_type, engine=engine, events=tot, expected=expect,
                ratio=ratio, err=err, per_pass=per_pass,
                ok=bool(abs(ratio - 1) < max(0.01, 3 * err)),
                drops=drops, seconds=el, passes=passes, n=n)


def run_rate(n: int, passes: int, types: List[int], engines: List[str],
             device, hsml: str = "tree") -> List[dict]:
    """Every (type, engine) on one box; prints a line per result."""
    p0, tree, _ = make_box(n, device, hsml)
    out = []
    for t in types:
        for e in engines:
            r = run_type(p0, tree, t, e, passes, n)
            r["hsml"] = hsml
            print(f"type {t} {e:5s}: events={r['events']} expected="
                  f"{r['expected']:.0f} ratio={r['ratio']:.4f} +- "
                  f"{r['err']:.4f} {'OK' if r['ok'] else 'FAIL'} drops "
                  f"{r['drops']} [{r['seconds']:.1f}s]", flush=True)
            out.append(r)
    return out


def summary(results: List[dict]) -> str:
    lines = ["summary (measured/analytic, Poisson 1-sigma; bar "
             "max(1%, 3 sigma)):"]
    for r in results:
        lines.append(f"  type {r['type']} {r['engine']:5s}: "
                     f"{r['ratio']:.4f} +- {r['err']:.4f} "
                     f"{'OK  ' if r['ok'] else 'FAIL'} drops {r['drops']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=float, default=1e5)
    ap.add_argument("passes", nargs="?", type=int, default=256)
    ap.add_argument("types", nargs="*", type=int, default=[0, 1, 2, 3, 4])
    ap.add_argument("--engine", choices=("walk", "lists", "hash", "both"),
                    default="both")
    ap.add_argument("--hsml", choices=("tree", "knn", "knn-grown"),
                    default="tree",
                    help="initial smoothing lengths: tree_hsml_init_fused, "
                    "setup_smoothing_lengths at JAX's cap (JAX's harness) "
                    "or with the cap grown")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_intermixed_args(argv)
    if args.device is None:
        if not torch.cuda.is_available():
            raise SystemExit("validate_rate: no CUDA card; pass --device cpu "
                             "to run the plain versions on the CPU")
        args.device = "cuda"
    dev = torch.device(args.device)
    engines = ["walk", "lists"] if args.engine == "both" else [args.engine]
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"N={int(args.n)} passes={args.passes} types={args.types} "
          f"engines={engines} hsml={args.hsml} device={kind}", flush=True)
    res = run_rate(int(args.n), args.passes, args.types, engines, dev,
                   args.hsml)
    print(summary(res))
    print(json.dumps({"rate": [{k: v for k, v in r.items()
                                if k != "per_pass"} for r in res],
                      "device": kind}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
