"""Simulation parameter containers.

Rebuild of the reference's two-tier parameter model
(``SimulationSettings`` at construction time, ``TickSettings`` per tick;
see reference ``src/simulation.rs:95-122``). The 30-field GPU uniform block
(``src/simulation.rs:53-90``) disappears entirely: static, shape-determining
values live in :class:`SimSettings` (hashable, closed over by ``jit``),
while per-tick tunables live in :class:`TickParams`, a JAX pytree of traced
scalars so every field can change *without recompilation* — the
equivalent of the reference's ``queue.write_buffer`` uniform update
(``src/simulation.rs:499``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

PI = math.pi
# f32 machine epsilon, matching the reference's EPSILON (funcs.wgsl:55).
EPSILON = 1.19209290e-07
# Hard speed clamp applied after force integration (compute.wgsl:118-122).
MAX_SPEED = 500.0


@dataclasses.dataclass(frozen=True)
class SimSettings:
    """Construction-time settings (static under jit).

    Mirrors reference ``SimulationSettings`` (``src/simulation.rs:95-104``)
    plus capacity knobs of the bounded engines. Defaults follow ``src/main.rs:48-54``
    and ``src/renderer.rs:16``.
    """

    particle_count: int = 100_000
    particle_spacing: float = 0.1
    smoothing_radius: float = 0.2
    # World bounds (width, height); particles live in [-size/2, size/2].
    size: Tuple[float, float] = (53.0, 53.0)
    # Obstacle force-field texture resolution (src/renderer.rs:16).
    texture_size: Tuple[int, int] = (1024, 1024)
    # Max particles per grid cell the neighbor machinery can see. The WGSL
    # kernels walk unbounded per-cell runs (compute.wgsl:182-229); here
    # shapes are static, so per-cell work is bounded by this capacity. Overflow degrades deterministically
    # (dropped neighbor contributions; dropped particles in resident mode,
    # counted in GridState.lost) and is flagged by
    # utils.profiling.health_check.
    #
    # Sizing: rest occupancy at reference defaults is 4/cell (spacing 0.1,
    # h 0.2); measured true compression in a g=-9.8 dam-break at k=50 is
    # ~28/cell, and UNDERSIZING feeds back (overflowed particles stop
    # contributing pressure -> deeper piling). Use 8 for zero-gravity
    # scenes, >=32 for gravity/dam-break scenes. Cost scales ~capacity^2
    # in the stencil kernels.
    # Default sized for the reference's one hardcoded scene (100k in a
    # 53x53 box at g=-9.8, src/main.rs:48-54): peak occupancy 6 over 1000
    # steps. Spare slots cost the resident rebin memory traffic, so
    # heavier scenes are covered by FluidApp capacity_policy "grow"
    # (audit + regrow-and-replay) or "strict" (sized refusal).
    cell_capacity: int = 8
    # Spawn-lattice column count override. The default (None) reproduces
    # the reference's sqrt(n)-wide lattice (src/simulation.rs:147-163).
    # The resident grid pads its width to a multiple of 128 columns
    # (tpufluid.ops.resident._gxp), so a world whose grid_w is such a
    # multiple carries no empty pad columns; a narrower spawn lattice lets
    # the world shrink to that boundary (see models.scene_1m).
    spawn_columns: Optional[int] = None

    def __post_init__(self):
        if self.particle_count <= 0:
            raise ValueError(f"particle_count must be > 0, got {self.particle_count}")
        if self.smoothing_radius <= 0:
            raise ValueError(f"smoothing_radius must be > 0, got {self.smoothing_radius}")
        if self.particle_spacing <= 0:
            raise ValueError(f"particle_spacing must be > 0, got {self.particle_spacing}")
        if self.size[0] <= 0 or self.size[1] <= 0:
            raise ValueError(f"size must be positive, got {self.size}")
        if self.cell_capacity <= 0:
            raise ValueError(f"cell_capacity must be > 0, got {self.cell_capacity}")

    @property
    def grid_w(self) -> int:
        # ceil(size/h) + 2: one-cell sentinel ring (src/simulation.rs:140).
        return int(math.ceil(self.size[0] / self.smoothing_radius)) + 2

    @property
    def grid_h(self) -> int:
        return int(math.ceil(self.size[1] / self.smoothing_radius)) + 2

    @property
    def num_cells(self) -> int:
        return self.grid_w * self.grid_h

    @property
    def sqr_radius(self) -> float:
        return self.smoothing_radius * self.smoothing_radius

    def kernel_norms(self) -> "KernelNorms":
        return KernelNorms.from_radius(self.smoothing_radius)


def suggest_cell_capacity(settings: SimSettings, params=None,
                          safety: float = 1.3, rounded: bool = True):
    """Cell capacity that keeps the bounded-capacity engines loss-free.

    The reference's per-cell loops are unbounded (compute.wgsl:182-229), so
    it never sheds mass; the bounded engines cap per-cell work by
    ``cell_capacity`` and must be sized for the scene's true peak
    occupancy. The spawn lattice packs ``occ0 = (h / spacing)^2`` per
    cell; two compression estimates are combined (max), both from the
    linear EOS ``p = k rho`` (funcs.wgsl:152-154):

    * settled pool: ``exp(0.55 * g * H_pool / k)`` with
      ``H_pool = N spacing^2 / size_x`` — hydrostatic floor occupancy;
    * impact: ``exp(0.9 * g * H_fall / k)`` with ``H_fall`` = spawn-column
      top to floor — kinetic energy converting to EOS compression when the
      falling column lands. Calibrated on measured unbounded (K=64) peaks:
      the 4k/16x16 dam-break peaks at 28/cell = 7x (gH/k = 2.2); the
      16k/26x26 one (gH/k = 3.8) never stops compacting (77+/cell and
      climbing) — with rest_density 0 there is no density the EOS defends,
      so strong-gravity scenes can compact without bound. The exponent is
      capped at 3 (20x): beyond that the bounded engines are the wrong
      tool — use neighbor_mode='grid', whose windows follow the sorted
      array.

    ``safety``/``rounded``: the padded, tile-rounded recommendation for
    sizing; FluidApp's refusal compares against the raw (safety=1,
    unrounded) estimate so marginal-but-workable configs still run.
    """
    occ0 = max(1.0, (settings.smoothing_radius
                     / settings.particle_spacing) ** 2)
    g = 0.0
    kp = 50.0
    if params is not None:
        g = float(max(abs(float(params.gravity[0])),
                      abs(float(params.gravity[1]))))
        kp = float(params.pressure_constant)
    pool_h = min(settings.particle_count * settings.particle_spacing ** 2
                 / settings.size[0], settings.size[1])
    col_top = 0.5 * math.sqrt(settings.particle_count) \
        * settings.particle_spacing
    fall_h = min(col_top + settings.size[1] * 0.5, settings.size[1])
    kp = max(kp, EPSILON)
    x = max(0.55 * g * pool_h / kp, 0.9 * g * fall_h / kp)
    factor = math.exp(min(x, 3.0))
    cap = occ0 * factor * safety
    if not rounded:
        return cap
    # round up to the 8-slot tile the resident GPU kernels block on
    return max(8, -(-int(math.ceil(cap)) // 8) * 8)


@dataclasses.dataclass(frozen=True)
class KernelNorms:
    """2D SPH kernel normalization constants.

    Precomputed once per settings, matching the per-tick host computation in
    the reference (``src/simulation.rs:486-490``).
    """

    poly6_volume: float
    poly6_gradient: float
    poly6_laplacian: float
    spiky_derivative: float
    viscosity: float

    @staticmethod
    def from_radius(h: float) -> "KernelNorms":
        return KernelNorms(
            poly6_volume=4.0 / (PI * h**8),
            poly6_gradient=24.0 / (PI * h**8),
            poly6_laplacian=8.0 / (PI * h**8),
            spiky_derivative=12.0 / (PI * h**4),
            viscosity=15.0 / (2.0 * PI * h**3),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TickParams:
    """Per-tick tunable parameters (a traced pytree).

    Field-for-field equivalent of reference ``TickSettings``
    (``src/simulation.rs:107-122``); defaults from ``src/renderer.rs:374-388``.
    ``mouse_*`` realizes the interactive impulse source as a plain API input
    (compute.wgsl:99-108 semantics).
    """

    delta: jax.Array
    gravity: jax.Array
    mass: jax.Array
    pressure_constant: jax.Array
    rest_density: jax.Array
    damping_factor: jax.Array
    viscosity_coefficient: jax.Array
    surface_tension_threshold: jax.Array
    surface_tension_coefficient: jax.Array
    mouse_force_radius: jax.Array
    mouse_force_power: jax.Array
    mouse_pos: jax.Array
    mouse_state: jax.Array  # int32: -1 repel, +1 attract, 0 off

    @staticmethod
    def default(**overrides) -> "TickParams":
        vals = dict(
            delta=1.0 / 120.0,
            gravity=(0.0, 0.0),
            mass=1.0,
            pressure_constant=50.0,
            rest_density=0.0,
            damping_factor=0.1,
            viscosity_coefficient=25.0,
            surface_tension_threshold=0.1,
            surface_tension_coefficient=35.0,
            mouse_force_radius=5.0,
            mouse_force_power=150.0,
            mouse_pos=(0.0, 0.0),
            mouse_state=0,
        )
        vals.update(overrides)
        f32 = lambda v: jnp.asarray(v, jnp.float32)
        return TickParams(
            delta=f32(vals["delta"]),
            gravity=f32(vals["gravity"]),
            mass=f32(vals["mass"]),
            pressure_constant=f32(vals["pressure_constant"]),
            rest_density=f32(vals["rest_density"]),
            damping_factor=f32(vals["damping_factor"]),
            viscosity_coefficient=f32(vals["viscosity_coefficient"]),
            surface_tension_threshold=f32(vals["surface_tension_threshold"]),
            surface_tension_coefficient=f32(vals["surface_tension_coefficient"]),
            mouse_force_radius=f32(vals["mouse_force_radius"]),
            mouse_force_power=f32(vals["mouse_force_power"]),
            mouse_pos=f32(vals["mouse_pos"]),
            mouse_state=jnp.asarray(vals["mouse_state"], jnp.int32),
        )
