"""Forked-shader variants (SURVEY.md section 2.12) + multi-step scan."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpufluid import (
    SimSettings, TickParams, init_state, make_multi_step, make_step,
)
from tpufluid.state import ParticleState


def settings(n=256, cap=32):
    return SimSettings(particle_count=n, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(8.0, 8.0),
                       cell_capacity=cap)


def test_x_wrap_teleports():
    s = settings(n=4, cap=8)
    step = make_step(s, x_boundary="wrap")
    pos = jnp.asarray([[3.9, 0.0], [-3.9, 1.0], [0.0, 3.9], [1.0, 0.0]],
                      jnp.float32)
    vel = jnp.asarray([[100.0, 0.0], [-100.0, 0.0], [0.0, 100.0], [0.0, 0.0]],
                      jnp.float32)
    state = ParticleState(position=pos, predicted=pos, velocity=vel,
                          density=jnp.ones(4), cell=jnp.zeros(4, jnp.uint32),
                          tick=jnp.zeros((), jnp.uint32))
    params = TickParams.default(pressure_constant=0.0,
                                viscosity_coefficient=0.0,
                                damping_factor=0.25)
    out = step(state, params)
    p, v = np.asarray(out.position), np.asarray(out.velocity)
    # x-movers teleported to the opposite wall, velocity unchanged
    for i in range(4):
        if abs(p[i, 0]) >= 4.0 - 1e-6 and abs(v[i, 0]) > 1.0:
            assert np.sign(p[i, 0]) == -np.sign(v[i, 0])
            assert abs(abs(v[i, 0]) - 100.0) < 1e-3  # no damping applied
    # y still bounces with damping
    yhit = np.abs(p[:, 1]) >= 4.0 - 1e-6
    assert yhit.any()
    assert np.any(np.isclose(v[yhit, 1], -25.0, rtol=1e-4))


def test_adaptive_subsampling_reduces_pressure_neighbors():
    # pile particles into one cell so density > 200 -> stride 13
    s = settings(n=64, cap=64)
    rng = np.random.default_rng(0)
    pos = (rng.uniform(-0.05, 0.05, (64, 2))).astype(np.float32)
    state = ParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.zeros((64, 2)), density=jnp.ones(64),
        cell=jnp.zeros(64, jnp.uint32), tick=jnp.zeros((), jnp.uint32))
    params = TickParams.default(gravity=(0.0, 0.0))
    full = make_step(s)(state, params)
    sub = make_step(s, adaptive_subsampling=True)(state, params)
    # density identical (subsampling applies to pressure only)
    np.testing.assert_array_equal(np.asarray(full.density),
                                  np.asarray(sub.density))
    assert float(jnp.max(full.density)) > 200.0
    # velocities differ: fewer pressure pairs were summed
    assert not np.allclose(np.asarray(full.velocity), np.asarray(sub.velocity))
    assert np.all(np.isfinite(np.asarray(sub.velocity)))


def test_adaptive_subsampling_noop_at_low_density():
    s = settings()
    params = TickParams.default(gravity=(0.0, -9.8))
    state = init_state(s)
    a = make_step(s)(state, params)
    b = make_step(s, adaptive_subsampling=True)(state, params)
    # initial lattice density ~101 < 150: stride 1 everywhere -> identical
    np.testing.assert_array_equal(np.asarray(a.velocity), np.asarray(b.velocity))


def test_density_clamp_blue_render():
    from tpufluid.ops import render
    s = settings(n=128, cap=128)
    pos = np.zeros((128, 2), np.float32)
    from tpufluid.ops import grid as gridops
    state = ParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.zeros((128, 2)), density=jnp.ones(128),
        cell=gridops.cell_id(jnp.asarray(pos), s).astype(jnp.uint32),
        tick=jnp.zeros((), jnp.uint32))
    cam = render.Camera(view_size=(2.0, 2.0))
    frame = np.asarray(render.render_metaball(
        state, s, 16, 16, cam, chunks=1, density_clamp_blue=True))
    # 64 stacked particles -> metaball density >> 50 at the center pixel
    np.testing.assert_allclose(frame[8, 8, :3], [0.0, 0.0, 1.0], atol=1e-6)


def test_multi_step_matches_python_loop():
    s = settings()
    params = TickParams.default(gravity=(0.0, -9.8))
    step = make_step(s)
    state_a = init_state(s)
    for _ in range(8):
        state_a = step(state_a, params)
    state_b = make_multi_step(s, 8)(init_state(s), params)
    # XLA fuses the scan body slightly differently than the standalone
    # step -> last-ulp differences; equality is semantic, not bitwise
    np.testing.assert_allclose(np.asarray(state_a.position),
                               np.asarray(state_b.position), atol=1e-6)
    np.testing.assert_allclose(np.asarray(state_a.velocity),
                               np.asarray(state_b.velocity), atol=1e-4)
    assert int(state_b.tick) == 8


# ---------------------------------------------------------------------
# Variants on the fast engines (dense / resident): the reference implements surface tension in its one engine
# (compute.wgsl:303-498) and the fork strides the pressure loop
# (shaders/compute.wgsl:170-174,195); every tpufluid engine carries both.
# ---------------------------------------------------------------------

def st_settings(n=36, cap=8):
    # h > 1 so the color-field gradient is non-zero: the reference passes
    # the NORMALIZED direction to poly6_gradient (|r| = 1), which zeroes
    # the gradient whenever h <= 1 (pairs.color_field_gradient docstring).
    # Kept tiny: interpreter-mode Pallas cost scales with the K unroll.
    return SimSettings(particle_count=n, particle_spacing=0.75,
                       smoothing_radius=1.5, size=(12.0, 12.0),
                       cell_capacity=cap)


def _run(s, mode, n_steps=3, **kw):
    step = make_step(s, neighbor_mode=mode, **kw)
    state = init_state(s)
    params = TickParams.default(gravity=(0.0, -2.0),
                                surface_tension_threshold=0.05,
                                surface_tension_coefficient=5.0)
    for _ in range(n_steps):
        state = step(state, params)
    return state


@pytest.mark.slow
def test_surface_tension_engines_agree():
    ref = _run(st_settings(), "grid", surface_tension=True)
    base = _run(st_settings(), "grid", surface_tension=False)
    # the variant actually does something at h=1.5
    assert not np.allclose(np.asarray(ref.velocity), np.asarray(base.velocity))
    for mode in ("naive", "dense"):
        out = _run(st_settings(), mode, surface_tension=True)
        np.testing.assert_allclose(
            np.asarray(out.position), np.asarray(ref.position), atol=2e-5,
            err_msg=f"mode={mode}")


@pytest.mark.slow
def test_surface_tension_resident_matches_dense():
    from tpufluid.ops import resident
    from scipy.spatial import cKDTree

    s = st_settings()
    params = TickParams.default(gravity=(0.0, -2.0),
                                surface_tension_threshold=0.05,
                                surface_tension_coefficient=5.0)
    ref = init_state(s)
    rstep = make_step(s, neighbor_mode="dense", surface_tension=True)
    gs = resident.init_grid_state(s)
    gstep = resident.make_grid_step(s, surface_tension=True)
    for _ in range(3):
        ref = rstep(ref, params)
        gs = gstep(gs, params)
    ps, live = resident.to_particles(gs, s)
    assert int(live) == s.particle_count
    d, _ = cKDTree(np.asarray(ref.position)).query(
        np.asarray(ps.position)[: s.particle_count])
    assert d.max() < 1e-4


@pytest.mark.slow
def test_adaptive_subsampling_engines():
    # piled particles: density > 200 -> stride 13 on the pressure loop
    # (keep cap small: interpreter-mode Pallas cost scales with the unroll)
    n = 16
    s = settings(n=n, cap=16)
    rng = np.random.default_rng(0)
    pos = (rng.uniform(-0.05, 0.05, (n, 2))).astype(np.float32)
    state = ParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.zeros((n, 2)), density=jnp.ones(n),
        cell=jnp.zeros(n, jnp.uint32), tick=jnp.zeros((), jnp.uint32))
    params = TickParams.default(gravity=(0.0, 0.0))
    ref = make_step(s, adaptive_subsampling=True)(state, params)
    assert float(jnp.max(ref.density)) > 200.0
    full = make_step(s, neighbor_mode="dense")(state, params)
    for mode in ("naive", "dense"):
        out = make_step(s, neighbor_mode=mode,
                        adaptive_subsampling=True)(state, params)
        np.testing.assert_allclose(
            np.asarray(out.velocity), np.asarray(ref.velocity), atol=1e-4,
            err_msg=f"mode={mode}")
        # and it differs from the unsubsampled forces
        assert not np.allclose(np.asarray(out.velocity),
                               np.asarray(full.velocity))


@pytest.mark.slow
def test_adaptive_subsampling_resident():
    """Low density -> stride 1 -> bitwise no-op; piled -> finite + differs.
    (The resident packing order differs from sort order, so the STRIDED
    SUBSET of neighbors differs from the [N] engines — same semantics,
    different sample; exact parity only holds at stride 1. cap stays 8:
    interpreter-mode cost doubles per capacity-slice variant, and the
    dispatch has its own test in test_resident.)"""
    from tpufluid.ops import resident

    s = settings(n=128, cap=8)
    params = TickParams.default(gravity=(0.0, -9.8))
    a = resident.make_grid_step(s)(resident.init_grid_state(s), params)
    b = resident.make_grid_step(s, adaptive_subsampling=True)(
        resident.init_grid_state(s), params)
    np.testing.assert_array_equal(np.asarray(a.pos_x), np.asarray(b.pos_x))
    np.testing.assert_array_equal(np.asarray(a.vel_y), np.asarray(b.vel_y))

    # pile: one dense clump -> density > 200 (cap 8: overflow drops some
    # neighbor contributions equally in both runs; the stride effect on
    # the kept pairs is what's under test)
    n2 = 16
    s2 = settings(n=n2, cap=8)
    rng = np.random.default_rng(1)
    pos = (rng.uniform(-0.05, 0.05, (n2, 2))).astype(np.float32)
    st = ParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.zeros((n2, 2)), density=jnp.ones(n2),
        cell=jnp.zeros(n2, jnp.uint32), tick=jnp.zeros((), jnp.uint32))
    gs0 = resident.from_particles(st, s2)
    ga = resident.make_grid_step(s2)(gs0, TickParams.default())
    gb = resident.make_grid_step(s2, adaptive_subsampling=True)(
        gs0, TickParams.default())
    va = np.asarray(ga.vel_x)[np.asarray(ga.pos_x) < 1e8]
    vb = np.asarray(gb.vel_x)[np.asarray(gb.pos_x) < 1e8]
    assert np.all(np.isfinite(vb))
    assert not np.allclose(va, vb)
