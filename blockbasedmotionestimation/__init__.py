"""Block-based motion estimation in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
ashish-nr/BlockBasedMotionEstimation: coarse-to-fine image-pyramid block
matching (spiral-order SAD search expressed as a vectorized cost-volume
argmin) with iterative 8-connected MV regularization and progressive block
subdivision, plus Middlebury .flo I/O, flow colorization, and EPE evaluation.

Public API:
  * MotionConfig / middlebury_config - pipeline configuration
  * estimate_flow - end-to-end JAX engine (padded-frame flow field)
  * estimate_flow_driver - the reference driver scenario (interp-factor
    upsample -> engine -> subsample), original-resolution quarter-pel flow
  * utils.flowio - .flo read/write, color coding, average EPE
"""

from blockbasedmotionestimation.config import (
    MotionConfig,
    middlebury_config,
    tiny_config,
)

__version__ = "0.1.0"

__all__ = [
    "MotionConfig",
    "middlebury_config",
    "tiny_config",
    "__version__",
]
