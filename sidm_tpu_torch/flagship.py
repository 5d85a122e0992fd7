"""bench.py's flagship problem for the ported slices.

``flagship_config(**DSMC)`` is flagship-dsmc, bench.py's own run: the
lists' configuration below with bench.py's SIDM settings (``SIDMOn 1``,
``CrossSection 38.2614``, ``ProbabilityTol 0.2``, ``RandomSeed1/2
55/497527``; ``DesNumNgb 30`` and ``MaxNumNgbDeviation 2`` are already in
the base), DSMC on the cached candidate lists, with the same two cuts.
``flagship_config(**DSMC_WALK)`` (``DSMC`` with ``ListMode 0``) is
flagship-dsmc-walk: the same SIDM settings on the walk, bench.py's
``TreeRefreshSteps 16``, the DSMC pass on the range walk every step.

``flagship_config(**VELDISP)`` is flagship-veldisp: the lists'
configuration with ``VelDispOn 1`` and ``TypeOfTimestepCriterion 4``
(the velocity-dispersion pass after every force, the timesteps from the
local dispersion and density), gravity only, since ``VelDispOn`` excludes
``SIDMOn``.

``small_config()`` is small-halo: bench.py's halo and SIDM settings on
the single-program step (``mode="synchronized"`` below
``Simulation.PHASE_THRESHOLD``: the wq walk's force every step and the
hash-grid DSMC engine), at its largest N, ``SMALL_N`` = 2^18 - 256
(``make_particles`` pads to a multiple of 256). ``ListMode`` and
``TreeRefreshSteps`` do not act on that step.

The configuration is bench.py:44-56 (NFW halo, relative opening criterion,
``ErrTolForceAcc 0.005``, reflection boundary, synchronized steps) with
``SIDMOn 0`` and ``TreeWalkEngine wq``, on the cached interaction lists
(``ListMode 1``, bench.py's default). ``flagship_config(ListMode=0)`` is
the first slice's configuration: the walk on every step, rebuilt every
``TreeRefreshSteps 16``. The halo is the NFW profile of parameter.txt:3-11
in kpc / 1e10 Msun / km s^-1 units.

On the lists two settings differ from bench.py's; both are chosen cuts
(PERF.md, Cells):
* ``TreeRefreshSteps 4`` (bench.py: 16). The list skin is 2.5 x the largest
  displacement rate x the last dt x the cadence. In this configuration it
  reaches 5.5 kpc at 16 and at 8 (measured on an H100,
  ``profile_step.py --cadence``), where the recording walk drops opened
  cells (``ovf[0]``) and the port gives the lists up for the walk; at 4 it
  stays overflow-free. Whether bench.py's DSMC run, whose timestep
  criterion also bounds the scattering probability, learns a smaller skin
  at 16 is not measured.
* ``ListNearCap 8192`` (default 5120): at the cadence of 4 the near lists
  need up to 6455 entries per group. The cap refit would find that too,
  but only after an overflowed record: that step's record (~0.38 s at
  N = 1e6) is thrown away, the walk recomputes it (~0.23 s) and the cadence
  restarts, more than a whole 4-step cycle costs.
"""

from __future__ import annotations

from .config import SimConfig
from .io import ics

FLAGSHIP = dict(
    SIDMOn=0, ForceMethod="tree", ErrTolTheta=0.5, TypeOfOpeningCriterion=1,
    ErrTolForceAcc=0.005, TypeOfTimestepCriterion=1, ErrTolVelScale=0.66,
    ErrTolDynamicalAccuracy=0.004, MaxSizeTimestep=0.1, TimeBegin=0.0,
    TimeMax=500.0, SofteningHalo=0.3, SofteningHaloMaxPhys=0.3,
    DesNumNgb=30, MaxNumNgbDeviation=2, TreeRefreshSteps=16,
    ReflectionBoundary=1114.35, TreeWalkEngine="wq", ListMode=0,
    UnitLength_in_cm=3.085678e21, UnitMass_in_g=1.989e43,
    UnitVelocity_in_cm_per_s=1e5)


# the second slice: the cached interaction lists
LISTS = dict(ListMode=1, TreeRefreshSteps=4, ListNearCap=8192)

# bench.py:44-47's SIDM settings (flagship-dsmc: flagship_config(**DSMC))
DSMC = dict(SIDMOn=1, CrossSection=38.2614, ProbabilityTol=0.2,
            RandomSeed1=55, RandomSeed2=497527)

# flagship-dsmc-walk: bench.py's SIDM settings on the walk (the DSMC pass
# on the range walk every step; TreeRefreshSteps 16, bench.py's)
DSMC_WALK = dict(DSMC, ListMode=0)


# flagship-veldisp: flagship_config(**VELDISP), the lists' configuration
# with the velocity-dispersion pass and timestep criterion 4 (gravity only:
# config.py refuses SIDMOn with VelDispOn)
VELDISP = dict(VelDispOn=1, TypeOfTimestepCriterion=4)


# small-halo: the single-program step's largest N (padded to 256)
SMALL_N = (1 << 18) - 256


def small_config(**changes) -> SimConfig:
    """small-halo: bench.py's halo and SIDM settings on the single-program
    step (run it with N <= SMALL_N and ``mode="synchronized"``)."""
    return SimConfig(**{**FLAGSHIP, **DSMC, **changes})


def flagship_config(**changes) -> SimConfig:
    """The lists' configuration; with ``ListMode=0`` the first slice's."""
    base = {**FLAGSHIP, **LISTS} if changes.get("ListMode", 1) else FLAGSHIP
    return SimConfig(**{**base, **changes})


def flagship_ics(n: int, seed: int = 12345):
    """(pos, vel, mass) numpy float64 of the N-particle NFW halo."""
    return ics.nfw(n, rho0=1.49e-4, rs=11.14356, G=43007.1, seed=seed)
