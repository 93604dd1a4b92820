"""tpufluid — SPH fluid simulation framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``rookieCookies/gpu-fluid-simulation`` (Rust + wgpu + WGSL): the particle
state is a SoA pytree, the whole sim tick is one jitted function, the
resident engine keeps particles in a cell slot grid and runs its physics
as Triton kernels on an NVIDIA GPU (plain jnp on the CPU), rendering is
headless render-to-array, obstacles use an on-device jump-flood distance
field, and multi-device scaling uses slab sharding with halo exchange.
"""

from .params import EPSILON, MAX_SPEED, KernelNorms, SimSettings, TickParams
from .state import ParticleState, init_state
from .step import make_multi_step, make_step, predict_positions

__all__ = [
    "EPSILON",
    "MAX_SPEED",
    "KernelNorms",
    "SimSettings",
    "TickParams",
    "ParticleState",
    "init_state",
    "make_multi_step",
    "make_step",
    "predict_positions",
]

__version__ = "0.1.0"
