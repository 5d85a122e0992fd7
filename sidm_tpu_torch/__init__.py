"""sidm_tpu_torch: the PyTorch + CUDA port of sidm_tpu for NVIDIA Hopper.

The JAX package ``sidm_tpu`` is the reference; this package mirrors its
module names and layout (``sidm_tpu/X.py`` -> ``sidm_tpu_torch/X.py``) and
never imports jax. Implemented so far: the phased step of the flagship on
the work-queue tree walk (``TreeWalkEngine wq``, ``ListMode 0``) and on
the cached interaction lists (``ListMode 1``), both also with DSMC
scattering (``SIDMOn 1``: on the cached candidate lists, or on the range
walk), and the periodic minimum image on the DSMC path's ops; everything
else raises ``NotImplementedError`` naming its ROADMAP item.

All work is float32 except the octree's moment sums, which are taken in
float64 and rounded once to float32 (see ``ops/tree.py``). TF32 is switched
off for matmuls and cuDNN below, so any float32 library call keeps full
float32 precision on the card.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import (SimConfig, Units, parse_parameter_file,  # noqa: E402
                     set_units)
from .state import (Particles, SystemState, make_particles,  # noqa: E402
                    state_dict, state_from_dict)

__all__ = ["SimConfig", "Units", "parse_parameter_file", "set_units",
           "Particles", "SystemState", "make_particles",
           "state_dict", "state_from_dict"]
