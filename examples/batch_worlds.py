"""Batched sweep demo: 8 independent worlds with differing gravity /
viscosity, stepped as ONE row-stacked resident grid (no vmap, one kernel
pass — see ops.resident.make_grid_step n_worlds).

Run: python examples/batch_worlds.py
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from tpufluid import SimSettings, TickParams
from tpufluid.ops import resident

B = 8
settings = SimSettings(particle_count=1024, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(10.0, 10.0),
                       cell_capacity=8)
plist = [
    TickParams.default(gravity=(0.0, -g), viscosity_coefficient=v)
    for g, v in zip(np.linspace(0.0, 2.0, B), np.linspace(5.0, 40.0, B))
]
params = resident.batched_params(plist)
gs = resident.init_batched_grid_state(settings, B)
step = resident.make_grid_step(settings, n_worlds=B)

for i in range(10):
    gs = step(gs, params)

print(f"tick={int(gs.tick)} lost={int(gs.lost)}")
for w in range(B):
    ps, live = resident.to_particles(
        resident.world_state(gs, settings, w), settings)
    y = np.asarray(ps.position)[: int(live), 1]
    print(f"world {w}: live={int(live):4d}  mean_y={y.mean():+.3f} "
          f"(gravity {float(plist[w].gravity[1]):+.2f})")
