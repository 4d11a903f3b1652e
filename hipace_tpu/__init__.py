"""hipace_tpu: a JAX quasi-static PIC framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of HiPACE++
(plasma wakefield acceleration, quasi-static PIC): the head-to-tail zeta
slice sweep runs as a lax.scan, field solves as batched DST/FFT and dense
multigrid, particle kernels as vectorized gathers/scatter-adds, and
multi-chip scaling as longitudinal pipeline parallelism over a
jax.sharding.Mesh.
"""

__version__ = "0.1.0"

from .constants import PhysConst, make_constants  # noqa: F401
from .geometry import Geometry  # noqa: F401
from .parser import Inputs  # noqa: F401
