"""The port's bench (``sidm_tpu_torch/bench.py``) runs bench.py's own
configuration: flagship-dsmc at bench.py's ``TreeRefreshSteps 16`` and
``ListNearCap 5120`` (bench.py:44-56), with ``TreeWalkEngine wq``."""

from sidm_tpu_torch import bench
from sidm_tpu_torch.flagship import DSMC, flagship_config


def test_bench_config_is_bench_py_s():
    cfg = bench.bench_config(16)
    assert cfg == flagship_config(**DSMC, TreeRefreshSteps=16,
                                  ListNearCap=5120)
    assert (cfg.SIDMOn, cfg.CrossSection, cfg.ProbabilityTol, cfg.ListMode,
            cfg.TreeRefreshSteps, cfg.ListNearCap, cfg.TreeWalkEngine,
            cfg.RandomSeed1, cfg.RandomSeed2, cfg.ErrTolForceAcc,
            cfg.TypeOfOpeningCriterion, cfg.ReflectionBoundary) == (
        1, 38.2614, 0.2, 1, 16, 5120, "wq", 55, 497527, 0.005, 1, 1114.35)
