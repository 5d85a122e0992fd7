"""The work-queue DSMC pass (port of ``sidm_tpu/ops/wq_range.py``:
``sidm_scatter_wq`` :332).

JAX's ``sidm_scatter_wq`` is its ``sidm_scatter_fused`` on the work-queue
schedule of the walk (items of equal size in place of per-block frontier
loops, a TPU schedule): the same gated windows, range walk and pair sets.
The port's range walk is already one launch over every group's whole
walk (``fused_range.range_segments``), so ``sidm_scatter_wq`` is
``fused_range.sidm_scatter_fused`` itself. The JAX Simulation picks this
function for ``TreeWalkEngine wq`` (``simulation.py:1242-1248``), but on
the JAX side it raises ``NameError`` (``wq_range.py:375`` calls
``_salt_u32``, which the module never imports; ROADMAP C.9), so the
port's walk engine is held against JAX's ``sidm_scatter_fused``.
"""

from __future__ import annotations

from .fused_range import sidm_scatter_fused as sidm_scatter_wq

__all__ = ["sidm_scatter_wq"]
