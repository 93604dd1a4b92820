"""Binned (gather-free) renderers vs the windowed reference renderers."""

import numpy as np

from tpufluid import SimSettings, TickParams, init_state, make_step
from tpufluid.ops import render
from tpufluid.ops.render import Camera
from tpufluid.ops.render_binned import (
    render_metaball_binned, render_particles_binned,
)


def make_scene():
    s = SimSettings(particle_count=256, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(8.0, 8.0), cell_capacity=64)
    state = make_step(s)(init_state(s), TickParams.default(gravity=(0.0, -9.8)))
    return s, state


def test_metaball_binned_matches_windowed():
    s, state = make_scene()
    cam = Camera(view_size=(8.0, 8.0))
    a = np.asarray(render.render_metaball(state, s, 64, 48, cam, chunks=4))
    b = np.asarray(render_metaball_binned(state, s, 64, 48, cam))
    assert b.shape == (48, 64, 4)
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_metaball_binned_nonsquare_and_offcenter():
    s, state = make_scene()
    cam = Camera(center=(1.0, -0.5), view_size=(6.0, 3.0))
    a = np.asarray(render.render_metaball(state, s, 80, 40, cam, chunks=4))
    b = np.asarray(render_metaball_binned(state, s, 80, 40, cam))
    # coverage cutoffs differ slightly at the influence edge (5x5 cells vs
    # >=2.5h bins) where contributions are ~exp(-12.5)
    np.testing.assert_allclose(a, b, atol=5e-4)


def test_sprites_binned_matches_windowed():
    s, state = make_scene()
    cam = Camera(view_size=(8.0, 8.0))
    a = np.asarray(render.render_particles(state, s, 64, 64, cam,
                                           scale=0.12, chunks=4))
    b = np.asarray(render_particles_binned(state, s, 64, 64, cam, scale=0.12))
    # same pixels covered; colors equal where covered
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_binned_density_clamp_blue():
    import jax.numpy as jnp
    from tpufluid.state import ParticleState
    from tpufluid.ops import grid as gridops
    s = SimSettings(particle_count=128, size=(8.0, 8.0), smoothing_radius=0.2,
                    cell_capacity=128)
    pos = jnp.zeros((128, 2), jnp.float32)
    state = ParticleState(
        position=pos, predicted=pos, velocity=jnp.zeros((128, 2)),
        density=jnp.ones(128),
        cell=gridops.cell_id(pos, s).astype(jnp.uint32),
        tick=jnp.zeros((), jnp.uint32))
    cam = Camera(view_size=(2.0, 2.0))
    frame = np.asarray(render_metaball_binned(
        state, s, 16, 16, cam, density_clamp_blue=True, capacity=128))
    np.testing.assert_allclose(frame[8, 8, :3], [0.0, 0.0, 1.0], atol=1e-6)
