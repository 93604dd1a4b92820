"""Scene presets: the benchmark configurations (BASELINE.json).

The reference has exactly one hardcoded scene (100k particles in a 53x53
box, src/main.rs:48-54); these presets cover it plus the benchmark
ladder (4k oracle scene -> 64k -> 256k -> 1M -> 4M sharded).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..params import SimSettings, TickParams
from ..state import ParticleState, init_state
from ..step import make_step


@dataclasses.dataclass
class Scene:
    name: str
    settings: SimSettings
    params: TickParams

    def init(self) -> ParticleState:
        return init_state(self.settings)

    def make_step(self, **kw):
        return make_step(self.settings, **kw)


def default_scene(**overrides) -> Scene:
    """The reference's default scene (src/main.rs:48-54, renderer.rs:374-388)."""
    return Scene(
        name="reference-default-100k",
        settings=SimSettings(**overrides),
        params=TickParams.default(),
    )


def dam_break_4k() -> Scene:
    """Config 1: 4k particles, CPU-checkable oracle scene."""
    return Scene(
        name="dam-break-4k",
        settings=SimSettings(
            particle_count=4096, particle_spacing=0.1, smoothing_radius=0.2,
            size=(16.0, 16.0), cell_capacity=32,
        ),
        params=TickParams.default(gravity=(0.0, -9.8)),
    )


def scene_64k() -> Scene:
    """Config 2: 64k particles, sorted neighbor search.

    Laid out like scene_1m: a 512-column grid (no pad columns), spawn
    1008 columns at the reference rest packing (spacing = h/2 -> settled
    occupancy ~3.8), box height sized to the 66-row spawn lattice (+ the
    eighth-cell offset so f32 rounding never lands lattice rows ON a cell
    boundary): 36 grid rows.
    """
    return Scene(
        name="sph-64k",
        settings=SimSettings(
            particle_count=65536, particle_spacing=0.1, smoothing_radius=0.2,
            size=(101.95, 6.75), cell_capacity=8, spawn_columns=1008,
        ),
        params=TickParams.default(),
    )


def scene_256k() -> Scene:
    """Config 3: 256k particles + JFA surface render.

    Laid out like scene_64k (512-column grid, occupancy-4 slab, 261 spawn
    rows): a 134-row grid.
    """
    return Scene(
        name="sph-256k",
        settings=SimSettings(
            particle_count=262144, particle_spacing=0.1, smoothing_radius=0.2,
            size=(101.95, 26.25), cell_capacity=8, spawn_columns=1008,
        ),
        params=TickParams.default(),
    )


def scene_1m() -> Scene:
    """Config 4 base: 1M particles on one device.

    Tile-aligned world: grid_w = ceil(101.95/0.2)+2 = 512, a multiple of
    the resident grid's 128-column padding, so no column of the slot grid
    is an empty pad column. The spawn lattice is narrowed to
    1008 columns (SimSettings.spawn_columns) so the fluid fits the
    tighter box with the cell-aligned 2-columns-per-cell packing of the
    reference's defaults (spacing = h/2, src/main.rs:48-54). The box is
    offset an eighth-cell from the lattice (101.95, not 101.9) so f32
    rounding of the cell transform never lands lattice columns ON a cell
    boundary — at 101.9 the boundary ties scattered columns 1/3 per cell
    and inflated initial occupancy (and occ3-bounded kernel work) to 6;
    aligned, the scene starts at the true rest occupancy 4.
    """
    return Scene(
        name="sph-1m",
        settings=SimSettings(
            particle_count=1_048_576, particle_spacing=0.1,
            smoothing_radius=0.2, size=(101.95, 104.1), cell_capacity=8,
            spawn_columns=1008,
        ),
        params=TickParams.default(),
    )


def scene_4m() -> Scene:
    """Config 5: 4M particles, sharded across devices by row bands.

    Tile-aligned like scene_1m: grid 1024 x 1044 (no pad columns), spawn
    2016 columns so the fluid fills the box at the reference's rest
    packing (2 lattice columns per cell). 261 grid rows per device on a
    4-device mesh.
    """
    return Scene(
        name="sph-4m",
        settings=SimSettings(
            particle_count=4_194_304, particle_spacing=0.1,
            smoothing_radius=0.2, size=(204.35, 208.3), cell_capacity=8,
            spawn_columns=2016,
        ),
        params=TickParams.default(),
    )


def batch_scenes(scene: Scene, gravities, viscosities, **step_kw):
    """Config 4: vmap batch of B independent scenes with differing
    gravity/viscosity — the functional-design freebie the wgpu architecture
    cannot express.

    Returns (batched_state, batched_params, batched_step).
    """
    b = len(gravities)
    assert len(viscosities) == b
    state = scene.init()
    bstate = jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + x.shape), state)
    params = scene.params
    bparams = jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + x.shape), params)
    bparams.gravity = jnp.asarray(gravities, jnp.float32)
    bparams.viscosity_coefficient = jnp.asarray(viscosities, jnp.float32)
    step = make_step(scene.settings, **step_kw)
    bstep = jax.jit(jax.vmap(step))
    return bstate, bparams, bstep
