"""Regression: the sentinel ring must stay empty for exact-division configs.

When size/h divides exactly in f32 (h=0.5, size=8.0 -> size/h == 16.0),
wall-clamped particles used to land in cell floor(size/h)+1 == grid_dim-1 —
the outermost (sentinel) ring. The stencil kernels' row-clamp and roll-wrap
tricks assume that ring is empty, so wall particles got their own row
duplicated into the stencil: densities/forces exactly 2x. Fixed by clamping
cell coords to the interior [1, grid_dim-2] everywhere they are derived
(ops.grid.cell_xy, ops.slot_physics.cells_of, ops.resident far-mover path).
"""

import math

import jax.numpy as jnp
import numpy as np

from tpufluid import SimSettings, TickParams, init_state, make_step
from tpufluid.ops import grid as gridops
from tpufluid.ops import resident as residentops

F = np.float32


def _settings(n):
    # 4.0 / 0.5 == 8.0 exactly in f32: the failing configuration
    return SimSettings(particle_count=n, particle_spacing=0.1,
                       smoothing_radius=0.5, size=(4.0, 4.0),
                       cell_capacity=8)


def _wall_scene():
    """Particles on the top wall + corners + a few interior ones."""
    pts = [(-0.6, 2.0), (0.0, 2.0), (0.6, 2.0),   # top wall
           (2.0, 2.0), (-2.0, -2.0),              # corners
           (2.0, 0.0), (-2.0, 0.65),              # side walls
           (0.0, 0.0), (0.3, 0.1), (0.5, -1.0)]   # interior
    return np.asarray(pts, F)


def test_cell_xy_clamped_to_interior():
    s = _settings(8)
    gd = s.grid_w  # == ceil(8)+2 == 10; interior is 1..8
    assert gd == 10
    pts = jnp.asarray([(2.0, 2.0), (-2.0, -2.0), (2.0, -2.0)], jnp.float32)
    xy = np.asarray(gridops.cell_xy(pts, s))
    assert xy.max() <= gd - 2, xy
    assert xy.min() >= 1, xy
    np.testing.assert_array_equal(xy[0], [gd - 2, gd - 2])
    np.testing.assert_array_equal(xy[1], [1, 1])


def _naive_density(pos, h, mass):
    """All-pairs poly6 density, independent of any grid machinery."""
    h, mass = F(h), F(mass)
    norm = F(4.0) / (F(math.pi) * h ** F(8))
    off = pos[None, :, :] - pos[:, None, :]
    r2 = np.sum(off * off, axis=-1).astype(F)
    diff = (h * h - r2).astype(F)
    w = np.where(r2 > h * h, F(0), norm * diff * diff * diff)
    return (mass * w).sum(axis=1).astype(F)


def test_wall_density_matches_naive_all_engines():
    pos = _wall_scene()
    s = _settings(len(pos))
    params = TickParams.default()  # zero gravity/velocity: pred == pos
    want = _naive_density(pos, s.smoothing_radius, 1.0)

    base = init_state(s)
    state = type(base)(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.zeros_like(base.velocity), density=base.density,
        cell=base.cell, tick=base.tick)

    for mode in ("grid", "dense"):
        out = make_step(s, neighbor_mode=mode)(state, params)
        # output is in cell-sorted order; match rows by position
        got_pos = np.asarray(out.position)
        got_dens = np.asarray(out.density)
        for i, p in enumerate(pos):
            j = int(np.argmin(np.sum((got_pos - p) ** 2, axis=1)))
            np.testing.assert_allclose(
                got_dens[j], want[i], rtol=1e-5,
                err_msg=f"{mode}: wall particle {i} at {p}")


def test_resident_wall_step_matches_dense():
    pos = _wall_scene()
    s = _settings(len(pos))
    params = TickParams.default(gravity=(0.0, -9.8))
    base = init_state(s)
    state = type(base)(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.zeros_like(base.velocity), density=base.density,
        cell=base.cell, tick=base.tick)

    ref = make_step(s, neighbor_mode="dense")(state, params)
    gs = residentops.from_particles(state, s)
    gs = residentops.make_grid_step(s)(gs, params)
    assert int(gs.lost) == 0
    got, live = residentops.to_particles(gs, s)
    assert int(live) == len(pos)
    ref_pos = np.asarray(ref.position)
    got_pos = np.asarray(got.position)
    for i in range(len(pos)):
        j = int(np.argmin(np.sum((got_pos - ref_pos[i]) ** 2, axis=1)))
        np.testing.assert_allclose(got_pos[j], ref_pos[i], atol=1e-5,
                                   err_msg=f"particle {i}")
