"""Particle state: a structure-of-arrays pytree.

Replaces the reference's 32-byte AoS ``ParticleInstance`` storage buffer
(``src/simulation.rs:126-135`` / ``funcs.wgsl:1-8``) with SoA device arrays
in a pytree: each field is a contiguous vector, and the whole state
round-trips through ``jit`` / ``checkpoint`` for free. The complete simulation state is this
pytree plus the tick counter (cf. ``src/simulation.rs:12-17``), which makes
checkpoint/resume trivial (see tpufluid.utils.io).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .params import SimSettings


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ParticleState:
    """SoA particle state.

    position / predicted / velocity: f32[N,2]; density: f32[N];
    cell: u32[N] grid-cell key (funcs.wgsl:7 ``grid``); tick: u32 scalar.
    """

    position: jax.Array
    predicted: jax.Array
    velocity: jax.Array
    density: jax.Array
    cell: jax.Array
    tick: jax.Array

    @property
    def n(self) -> int:
        return self.position.shape[0]


def init_state(settings: SimSettings) -> ParticleState:
    """Centered sqrt(n) x sqrt(n) lattice at ``particle_spacing``.

    Exact reproduction of the reference's spawn layout
    (``src/simulation.rs:147-163``): row width = sqrt(n) (float), x index is
    ``i % floor(row_width)`` but centered with the *float* row width, y uses
    ``floor(i / row_width)`` centered on the derived column count.
    """
    n = settings.particle_count
    spacing = np.float32(settings.particle_spacing)
    if settings.spawn_columns is not None:
        # column-count override (SimSettings.spawn_columns): same
        # centered-lattice math with an explicit column count.
        per_row = np.float32(settings.spawn_columns)
    else:
        per_row = np.float32(np.sqrt(np.float32(n)))
    per_col = (np.float32(n) - 1.0) / per_row + 1.0

    i = np.arange(n, dtype=np.int64)
    xi = (i % int(per_row)).astype(np.float32)
    x = (xi - per_row * 0.5 + 0.5) * spacing
    y = (np.floor(i.astype(np.float32) / per_row) - per_col * 0.5 + 0.5) * spacing
    pos = np.stack([x, y], axis=-1).astype(np.float32)

    return ParticleState(
        position=jnp.asarray(pos),
        predicted=jnp.asarray(pos),
        velocity=jnp.zeros((n, 2), jnp.float32),
        density=jnp.zeros((n,), jnp.float32),
        cell=jnp.zeros((n,), jnp.uint32),
        tick=jnp.zeros((), jnp.uint32),
    )
