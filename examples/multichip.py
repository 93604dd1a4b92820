"""Slab-sharded simulation over a device mesh.

Runs on several GPUs or, as here, on virtual CPU devices:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip.py
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from tpufluid import SimSettings, TickParams
from tpufluid.parallel import (
    build_shard_spec, gather_state, init_sharded, make_sharded_step,
)

devices = jax.device_count()
settings = SimSettings(
    particle_count=8192, particle_spacing=0.1, smoothing_radius=0.2,
    size=(32.0, 16.0), cell_capacity=16,
)
spec = build_shard_spec(settings, devices)
step = make_sharded_step(spec, neighbor_mode="dense")
state = init_sharded(spec)
params = TickParams.default(gravity=(0.0, -9.8))

for i in range(60):
    state, stats = step(state, params)
    if i % 10 == 9:
        # keep the dispatch queue shallow: the virtual CPU mesh emulates
        # collectives with a 40s rendezvous timeout that deep async queues
        # of ppermute programs can trip
        jax.block_until_ready(state.position)
print("per-device particle counts:",
      np.asarray(stats["n_valid"]).tolist())
print("halo/migration drops:",
      int(np.asarray(stats["halo_dropped"]).sum()),
      int(np.asarray(stats["migration_dropped"]).sum()))
final = gather_state(state)
print("mean y after fall:", float(np.asarray(final.position)[:, 1].mean()))
