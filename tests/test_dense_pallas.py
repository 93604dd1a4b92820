"""Dense cell-grid and Pallas neighbor modes vs the windowed grid mode.

Pallas runs in interpreter mode on CPU — keep shapes tiny (K=8, small
grids) or these tests crawl.
"""

import jax.numpy as jnp
import numpy as np

from tpufluid import SimSettings, TickParams, init_state, make_step
from tpufluid.ops import dense as denseops
from tpufluid.ops import grid as gridops


def settings(n=256, cap=8, size=(6.0, 6.0)):
    return SimSettings(particle_count=n, particle_spacing=0.1,
                       smoothing_radius=0.2, size=size, cell_capacity=cap)


def test_ranks():
    cells = jnp.asarray([2, 2, 2, 5, 5, 9], jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(denseops.ranks(cells)), [0, 1, 2, 0, 1, 0])


def test_build_grid_roundtrip():
    s = settings()
    state = init_state(s)
    cells = gridops.cell_id(state.position, s)
    b = gridops.bin_particles(cells, s)
    pred_s = state.position[b.perm]
    vel_s = state.velocity[b.perm]
    grid = denseops.build_grid(pred_s, vel_s, b.sorted_cells, s)
    assert int(grid.n_dropped) == 0
    assert int(grid.valid.sum()) == 256
    # read back through flat slots: identity
    got = grid.px.reshape(-1)[np.asarray(grid.flat)]
    np.testing.assert_array_equal(got, np.asarray(pred_s[:, 0]))


def test_capacity_drop_counted():
    s = settings(n=32, cap=2)
    pos = jnp.zeros((32, 2), jnp.float32)  # all in one cell
    cells = gridops.cell_id(pos, s)
    b = gridops.bin_particles(cells, s)
    grid = denseops.build_grid(pos, pos, b.sorted_cells, s)
    assert int(grid.n_dropped) == 30
    assert int(grid.valid.sum()) == 2


def test_dense_and_pallas_match_grid():
    s = settings()
    params = TickParams.default(gravity=(0.0, -9.8))
    state = init_state(s)
    ref = make_step(s, neighbor_mode="grid")(state, params)
    for mode in ("dense",):
        out = make_step(s, neighbor_mode=mode)(state, params)
        np.testing.assert_allclose(
            np.asarray(ref.position), np.asarray(out.position),
            rtol=1e-5, atol=1e-6, err_msg=mode)
        np.testing.assert_allclose(
            np.asarray(ref.velocity), np.asarray(out.velocity),
            rtol=1e-4, atol=5e-5, err_msg=mode)
        np.testing.assert_allclose(
            np.asarray(ref.density), np.asarray(out.density),
            rtol=1e-5, err_msg=mode)
        np.testing.assert_array_equal(np.asarray(ref.cell),
                                      np.asarray(out.cell))


def test_dense_multi_step_trajectory_sane():
    s = settings()
    params = TickParams.default(gravity=(0.0, -9.8))
    step = make_step(s, neighbor_mode="dense")
    state = init_state(s)
    for _ in range(60):
        state = step(state, params)
    pos = np.asarray(state.position)
    assert np.all(np.isfinite(pos))
    assert np.all(np.abs(pos) <= 3.0 + 1e-5)
    assert pos[:, 1].mean() < 0.0  # fell under gravity


def test_dense_x_wrap_variant():
    s = settings(n=4)
    from tpufluid.state import ParticleState
    pos = jnp.asarray([[2.9, 0.0], [0.0, 0.0], [1.0, 1.0], [-1.0, 0.5]],
                      jnp.float32)
    vel = jnp.asarray([[100.0, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
                      jnp.float32)
    state = ParticleState(position=pos, predicted=pos, velocity=vel,
                          density=jnp.ones(4), cell=jnp.zeros(4, jnp.uint32),
                          tick=jnp.zeros((), jnp.uint32))
    params = TickParams.default(pressure_constant=0.0,
                                viscosity_coefficient=0.0)
    out = make_step(s, neighbor_mode="dense", x_boundary="wrap")(state, params)
    p = np.asarray(out.position)
    fast = np.argmax(np.abs(np.asarray(out.velocity)[:, 0]))
    assert p[fast, 0] == -3.0  # teleported to the left wall
