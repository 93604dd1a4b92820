"""Profiling and observability.

The reference's story is tracing_subscriber + println frame counters and a
1/90s frame-drop detector (SURVEY.md section 5). The equivalents here:
``jax.profiler`` trace capture, a steps/sec meter with proper device sync,
and a NaN/occupancy health check usable inside jit via ``jax.debug``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp


@dataclass
class StepTimer:
    """Steps/sec meter. Call ``lap(state)`` after each step; it blocks on the
    device result only when a report is due, keeping the pipeline async."""

    report_every: int = 120
    _count: int = 0
    _t0: Optional[float] = None
    last_rate: float = field(default=0.0)

    def lap(self, state) -> Optional[float]:
        return self.laps(state, 1)

    def laps(self, state, n: int) -> Optional[float]:
        """Account ``n`` steps delivered by one dispatch (burst runs —
        FluidApp.run — advance many ticks per device round-trip)."""
        if self._t0 is None:
            jax.block_until_ready(state)
            self._t0 = time.perf_counter()
            return None
        self._count += n
        if self._count < self.report_every:
            return None
        jax.block_until_ready(state)
        now = time.perf_counter()
        self.last_rate = self._count / (now - self._t0)
        self._count = 0
        self._t0 = now
        return self.last_rate


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace capture around a block (view with TensorBoard/xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def health_check(state, settings) -> dict:
    """Host-side sanity snapshot: NaN counts, bounds violations, cell
    occupancy vs capacity (the rebuild's replacement for the reference's
    defensive in-shader guards)."""
    import numpy as np
    from ..ops import grid as gridops

    pos = np.asarray(state.position)
    vel = np.asarray(state.velocity)
    # derive cells from predicted positions: state.cell is all-zeros on a
    # fresh state (init_state never bins), which would spuriously report
    # max_cell_occupancy == N before the first tick
    cells = gridops.cell_id(state.predicted, settings)
    binning = gridops.bin_particles(cells, settings)
    occ = int(gridops.max_cell_occupancy(binning.cell_start))
    half = np.asarray(settings.size) * 0.5
    return dict(
        nan_positions=int(np.isnan(pos).sum()),
        nan_velocities=int(np.isnan(vel).sum()),
        out_of_bounds=int((np.abs(pos) > half + 1e-4).any(axis=1).sum()),
        max_cell_occupancy=occ,
        cell_capacity=settings.cell_capacity,
        capacity_exceeded=occ > settings.cell_capacity,
        max_speed=float(np.linalg.norm(vel, axis=1).max()) if len(vel) else 0.0,
        tick=int(state.tick),
    )
