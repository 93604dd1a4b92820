"""The resident engine's GPU kernels (ops.pallas.triton_resident), run in
the Pallas interpreter against the plain stages (ops.slot_physics); the
plain rebin's packing and counting; and the choice of implementation per
backend. Scenes are tiny: the interpreter runs every program in Python."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpufluid import SimSettings, TickParams
from tpufluid.ops import forcefield as ffops
from tpufluid.ops import resident, slot_physics as sp
from tpufluid.ops.pallas import triton_resident as tr
from tpufluid.state import ParticleState

# the limits chip_smoke holds the compiled kernels to
DENSITY_LIMIT = 1e-5
STEP_LIMIT = 1e-4


def _settings(n=256, cap=8, size=(6.0, 6.0), **kw):
    return SimSettings(particle_count=n, particle_spacing=0.1,
                       smoothing_radius=0.2, size=size, cell_capacity=cap,
                       **kw)


def _pile_state(s, n_pile=12):
    """``n_pile`` particles in one cell, the rest spread out."""
    rng = np.random.default_rng(3)
    n = s.particle_count
    pos = np.zeros((n, 2), np.float32)
    pos[:n_pile] = rng.uniform(-0.05, 0.05, (n_pile, 2)) + [0.5, 0.5]
    pos[n_pile:] = rng.uniform(-1.5, 1.5, (n - n_pile, 2))
    st = ParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.zeros((n, 2)), density=jnp.ones(n),
        cell=jnp.zeros(n, jnp.uint32), tick=jnp.zeros((), jnp.uint32))
    return resident.from_particles(st, s)


def _case(name):
    """(grid state, settings, params, forces kwargs, wid) of one variant,
    after three plain resident steps."""
    params = TickParams.default(gravity=(0.0, -9.8))
    kw, wid, step_kw = {}, None, {}
    if name == "k16":
        s = _settings(n=64, cap=16, size=(3.4, 3.4))
        gs = _pile_state(s)
    else:
        s = _settings(texture_size=(64, 64))
        gs = resident.init_grid_state(s)
    if name == "st-adaptive-wrap":
        kw = step_kw = dict(surface_tension=True, adaptive_subsampling=True,
                            x_boundary="wrap")
        params = TickParams.default(gravity=(0.0, -9.8),
                                    surface_tension_threshold=0.05,
                                    surface_tension_coefficient=5.0)
    if name == "two-worlds":
        gs = resident.init_batched_grid_state(s, 2)
        params = resident.batched_params([
            TickParams.default(gravity=(0.0, -9.8)),
            TickParams.default(gravity=(1.0, -2.0),
                               viscosity_coefficient=10.0)])
        step_kw = dict(n_worlds=2)
        wid = jnp.repeat(jnp.arange(2, dtype=jnp.int32), s.grid_h)
    step = resident.make_grid_step(s, **step_kw)
    for _ in range(3):
        gs = step(gs, params)
    if name == "force-field":
        field = ffops.obstacle_force_field(
            ffops.Objects.from_list([("circle", (0.3, -0.2), 0.6)]), s)
        kw = dict(ff_cells=resident.forcefield_cells(
            field, s, gs.pos_x.shape[-1], n_rows=s.grid_h))
    return gs, resident.pad_capacity(s), params, kw, wid


def _rel(a, b, live):
    a, b = np.asarray(a)[live], np.asarray(b)[live]
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("variant", ["default", "st-adaptive-wrap",
                                     "force-field", "two-worlds", "k16"])
def test_triton_kernels_match_plain_stages(variant):
    gs, s, params, kw, wid = _case(variant)
    live = np.asarray(gs.pos_x) < sp.SENTINEL_HALF
    args = (gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row)
    dargs = (params.mass, params.delta, params.pressure_constant,
             params.rest_density, s)
    pres, invr = sp.density(*args, *dargs, wid=wid)
    pres_t, invr_t = tr.density(*args, *dargs, wid=wid, interpret=True)
    assert _rel(1.0 / invr_t, 1.0 / invr, live) <= DENSITY_LIMIT
    assert _rel(pres_t, pres, live) <= DENSITY_LIMIT
    # empty slots carry the floor defaults in both
    np.testing.assert_array_equal(np.asarray(invr_t)[~live],
                                  np.asarray(invr)[~live])

    frame = gs.tick + jnp.uint32(1)
    want = sp.forces_integrate(*args[:4], pres, invr, gs.occ_row, params, s,
                               frame, wid=wid, **kw)
    got = tr.forces_integrate(*args[:4], pres, invr, gs.occ_row, params, s,
                              frame, wid=wid, interpret=True, **kw)
    for a, b, name in zip(got, want, ("pos_x", "pos_y", "vel_x", "vel_y")):
        assert _rel(a, b, live) <= STEP_LIMIT, name
        # empty slots stay empty
        np.testing.assert_array_equal(np.asarray(a)[~live],
                                      np.asarray(b)[~live])


def _grid(s):
    shape = (s.grid_h, s.cell_capacity, resident._gxp(s))
    return (np.full(shape, sp.SENTINEL, np.float32),
            np.full(shape, sp.SENTINEL, np.float32),
            np.zeros(shape, np.float32), np.zeros(shape, np.float32))


def _cell_center(s, cx, cy):
    h = s.smoothing_radius
    return ((cx - 0.5) * h - s.size[0] / 2, (cy - 0.5) * h - s.size[1] / 2)


def _rebin(s, px, py, vx, vy):
    out = sp.rebin(*(jnp.asarray(a) for a in (px, py, vx, vy)),
                   jnp.float32(1.0 / 120.0), s)
    return [np.asarray(a) for a in out]


def test_rebin_packs_in_source_row_column_slot_order():
    """Arrivals into one cell pack by (source row, source column, slot);
    the packing the kernels' candidate order and the far-mover insert
    rely on (ops.resident module docstring)."""
    s = _settings(cap=8)
    px, py, vx, vy = _grid(s)
    ty, tx = 10, 12
    x0, y0 = _cell_center(s, tx, ty)
    # (source row, source column, slot) -> a distinct x offset (the tag)
    src = [((ty, tx), 0, 0.00), ((ty + 1, tx), 0, 0.01),
           ((ty, tx - 1), 1, 0.02), ((ty - 1, tx + 1), 0, 0.03),
           ((ty, tx - 1), 0, 0.04), ((ty - 1, tx - 1), 2, 0.05)]
    for (cy, cx), slot, tag in src:
        px[cy, slot, cx] = x0 + tag
        py[cy, slot, cx] = y0
    npx, npy, _, _, occ, far_n, over_n = _rebin(s, px, py, vx, vy)
    tags = npx[ty, :6, tx] - np.float32(x0)
    # row ty-1 (cols tx-1, tx+1), row ty (col tx-1 slots 0, 1; col tx),
    # row ty+1
    np.testing.assert_allclose(tags, [0.05, 0.03, 0.04, 0.02, 0.00, 0.01],
                               atol=1e-5)
    assert npx[ty, 6:, tx].min() >= sp.SENTINEL_HALF
    assert int(occ[ty]) == 6 and int(far_n.sum()) == 0
    assert int(over_n.sum()) == 0
    # every other cell is empty now
    assert int((npx < sp.SENTINEL_HALF).sum()) == 6


def test_rebin_counts_overflow_per_target_row():
    s = _settings(cap=2)
    px, py, vx, vy = _grid(s)
    ty, tx = 7, 9
    x0, y0 = _cell_center(s, tx, ty)
    for i, (cy, cx) in enumerate([(ty, tx - 1), (ty, tx), (ty + 1, tx + 1)]):
        px[cy, 0, cx] = x0 + 0.01 * i
        py[cy, 0, cx] = y0
    npx, _, _, _, occ, far_n, over_n = _rebin(s, px, py, vx, vy)
    assert int(over_n[ty]) == 1 and int(over_n.sum()) == 1
    assert int(occ[ty]) == 2
    # the first two in packing order are kept
    np.testing.assert_allclose(npx[ty, :, tx] - np.float32(x0), [0.0, 0.01],
                               atol=1e-5)


def test_rebin_leaves_far_movers_out_and_counts_them():
    s = _settings(cap=8)
    px, py, vx, vy = _grid(s)
    x0, y0 = _cell_center(s, 12, 10)
    px[10, 0, 12], py[10, 0, 12] = x0, y0
    px[10, 1, 12], py[10, 1, 12] = x0 + 0.01, y0
    vx[10, 1, 12] = 0.6 * 120.0  # three cells in one step
    npx, _, nvx, _, occ, far_n, over_n = _rebin(s, px, py, vx, vy)
    assert int(far_n[10]) == 1 and int(far_n.sum()) == 1
    assert int((npx < sp.SENTINEL_HALF).sum()) == 1
    assert float(npx[10, 0, 12]) == pytest.approx(x0)
    assert int(over_n.sum()) == 0


def test_physics_impl_cpu_is_plain():
    assert resident.physics_impl("cpu") == "plain"
    assert resident.physics_impl() == "plain"  # the tests run on the CPU
    density, forces = resident.physics_stages("plain")
    assert density is sp.density and forces is sp.forces_integrate


def test_physics_impl_unknown_platform_raises():
    with pytest.raises(RuntimeError, match="no physics for platform"):
        resident.physics_impl("tpu")
    with pytest.raises(ValueError, match="unknown physics"):
        resident.physics_stages("interpreted")


def test_gpu_stages_never_interpret():
    assert resident.physics_impl("gpu") == "triton"
    for stage in resident.physics_stages("triton"):
        assert isinstance(stage, functools.partial)
        assert stage.keywords == {"interpret": False}
        assert stage.func in (tr.density, tr.forces_integrate)


def test_gpu_step_lowers_to_compiled_triton_kernels():
    """The whole resident step, built for the GPU and lowered for CUDA
    here on the CPU: both kernels are Triton custom calls (an
    interpreted kernel would be inlined as plain HLO instead)."""
    s = _settings()
    step = resident.make_grid_step(s, impl="triton")
    gs = resident.init_grid_state(s)
    text = step.trace(gs, TickParams.default()).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 2
    assert "sph_density_triton" in text
    assert "sph_forces_integrate_triton" in text


def test_slot_tile_and_capacity_padding():
    pads = {k: resident.pad_capacity(_settings(cap=k)).cell_capacity
            for k in (1, 2, 3, 5, 8, 9, 16, 20)}
    assert pads == {1: 1, 2: 2, 3: 4, 5: 8, 8: 8, 9: 16, 16: 16, 20: 24}
    assert [tr.slot_tile(k) for k in (2, 4, 8, 16, 24)] == [2, 4, 8, 8, 8]
    with pytest.raises(ValueError):
        tr.slot_tile(12)
    with pytest.raises(ValueError, match="multiple of"):
        tr.density(*(jnp.zeros((4, 8, 100)),) * 4, jnp.zeros(4, jnp.int32),
                   1.0, 0.01, 50.0, 0.0, _settings(), interpret=True)
