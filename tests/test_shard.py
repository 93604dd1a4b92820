"""Multi-device slab sharding on a virtual 8-device CPU mesh
(SURVEY.md section 4, point 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpufluid import SimSettings, TickParams, init_state, make_step
from tpufluid.parallel import (
    build_shard_spec, gather_state, init_sharded, make_sharded_step,
)


def shard_settings(n=512):
    return SimSettings(
        particle_count=n, particle_spacing=0.1, smoothing_radius=0.2,
        size=(16.0, 8.0), cell_capacity=32,
    )


def sorted_points(pos):
    pos = np.asarray(pos)
    order = np.lexsort((pos[:, 1], pos[:, 0]))
    return pos[order]


@pytest.fixture(scope="module")
def eight_devices():
    if jax.device_count() < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax.devices()[:8]


def test_spec_construction(eight_devices):
    s = shard_settings()
    spec = build_shard_spec(s, 8)
    assert len(spec.col_bounds) == 9
    assert spec.col_bounds[0] == 1
    assert spec.col_bounds[-1] == s.grid_w - 1
    widths = np.diff(spec.col_bounds)
    assert widths.min() >= 3
    assert spec.capacity * 8 >= s.particle_count


def test_init_preserves_all_particles(eight_devices):
    s = shard_settings()
    spec = build_shard_spec(s, 8)
    st = init_sharded(spec)
    assert int(np.asarray(st.valid).sum()) == s.particle_count
    single = init_state(s)
    np.testing.assert_allclose(
        sorted_points(gather_state(st).position),
        sorted_points(single.position), atol=0,
    )


def test_sharded_dense_matches_single_chip_dense(eight_devices):
    """The slab-local dense grids must reproduce single-chip dense physics
    (same summation order => near-bitwise)."""
    s = shard_settings()
    spec = build_shard_spec(s, 8)
    params = TickParams.default(gravity=(0.0, -9.8))
    sh_state = init_sharded(spec)
    sh_step = make_sharded_step(spec, neighbor_mode="dense")
    single_state = init_state(s)
    single_step = make_step(s, neighbor_mode="dense")
    for i in range(2):
        sh_state, stats = sh_step(sh_state, params)
        single_state = single_step(single_state, params)
    assert int(np.asarray(stats["n_valid"]).sum()) == s.particle_count
    np.testing.assert_allclose(
        sorted_points(gather_state(sh_state).position),
        sorted_points(single_state.position), atol=1e-6,
    )


def test_sharded_matches_single_chip(eight_devices):
    s = shard_settings()
    spec = build_shard_spec(s, 8)
    params = TickParams.default(gravity=(0.0, -9.8))

    sh_state = init_sharded(spec)
    sh_step = make_sharded_step(spec)
    single_state = init_state(s)
    single_step = make_step(s)

    for i in range(5):
        sh_state, stats = sh_step(sh_state, params)
        single_state = single_step(single_state, params)
        assert int(np.asarray(stats["halo_dropped"]).sum()) == 0, f"step {i}"
        assert int(np.asarray(stats["migration_dropped"]).sum()) == 0
        assert int(np.asarray(stats["n_valid"]).sum()) == s.particle_count
        np.testing.assert_allclose(
            sorted_points(gather_state(sh_state).position),
            sorted_points(single_state.position),
            atol=5e-4, err_msg=f"step {i}",
        )


def test_migration_across_slabs(eight_devices):
    # strong sideways gravity pushes the block across slab boundaries
    s = shard_settings()
    # sideways pile-up concentrates all mass in the rightmost slab: give
    # every device capacity for the whole set
    spec = build_shard_spec(s, 8, capacity_factor=3.0)
    params = TickParams.default(gravity=(30.0, 0.0))
    sh_state = init_sharded(spec)
    sh_step = make_sharded_step(spec)
    occupancy_before = (
        np.asarray(sh_state.valid).reshape(8, -1).sum(axis=1))
    for _ in range(40):
        sh_state, stats = sh_step(sh_state, params)
    assert int(np.asarray(stats["n_valid"]).sum()) == s.particle_count
    occupancy_after = (
        np.asarray(sh_state.valid).reshape(8, -1).sum(axis=1))
    # mass moved right: the rightmost slabs gained particles
    assert occupancy_after[-2:].sum() > occupancy_before[-2:].sum()
    pos = np.asarray(gather_state(sh_state).position)
    assert np.all(np.isfinite(pos))
    assert pos[:, 0].mean() > 0.5  # drifted right


def test_sharded_determinism(eight_devices):
    s = shard_settings(n=256)
    spec = build_shard_spec(s, 8)
    params = TickParams.default(gravity=(3.0, -9.8))
    step = make_sharded_step(spec)

    def run():
        st = init_sharded(spec)
        for _ in range(10):
            st, _ = step(st, params)
        return st

    a, b = run(), run()
    np.testing.assert_array_equal(np.asarray(a.position), np.asarray(b.position))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))


def test_two_device_mesh(eight_devices):
    # smallest multi-chip case
    s = shard_settings(n=128)
    spec = build_shard_spec(s, 2)
    params = TickParams.default()
    step = make_sharded_step(spec)
    st = init_sharded(spec)
    for _ in range(3):
        st, stats = step(st, params)
    assert int(np.asarray(stats["n_valid"]).sum()) == 128


# ---------------------------------------------------------------------
# Resident-grid row-band sharding (the fast-engine multi-chip path)
# ---------------------------------------------------------------------

@pytest.mark.slow
def test_resident_sharded_matches_single_chip(eight_devices):
    """Row-band sharded resident step vs the single-chip resident engine:
    same kernels, same packing order => bitwise-equal positions."""
    from tpufluid.ops import resident
    from tpufluid.parallel import (
        build_resident_spec, gather_resident, init_sharded_resident,
        make_resident_mesh, make_sharded_resident_step)

    s = SimSettings(particle_count=512, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(8.0, 8.0), cell_capacity=8)
    params = TickParams.default(gravity=(0.0, -9.8))
    spec = build_resident_spec(s, 8)
    mesh = make_resident_mesh(spec)
    step = make_sharded_resident_step(spec, mesh=mesh)
    gs = init_sharded_resident(spec, mesh=mesh)
    ref = resident.init_grid_state(s)
    rstep = resident.make_grid_step(s)
    for _ in range(5):
        gs, stats = step(gs, params)
        ref = rstep(ref, params)
    assert int(np.asarray(stats["n_valid"]).sum()) == 512
    assert int(np.asarray(gs.lost)) == 0
    ps, live = gather_resident(gs, spec)
    pr, liver = resident.to_particles(ref, s)
    assert int(live) == 512 and int(liver) == 512
    np.testing.assert_array_equal(
        sorted_points(np.asarray(ps.position)[:512]),
        sorted_points(np.asarray(pr.position)[:512]))


def test_resident_sharded_far_movers(eight_devices):
    """Cross-band far movers ride the all_gather packet path and survive."""
    from tpufluid.ops import resident
    from tpufluid.parallel import (
        build_resident_spec, gather_resident, init_sharded_resident,
        make_resident_mesh, make_sharded_resident_step)
    from tpufluid.state import ParticleState

    s = SimSettings(particle_count=16, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(8.0, 8.0), cell_capacity=8)
    pos = np.zeros((16, 2), np.float32)
    pos[:, 0] = np.linspace(-3.5, 3.5, 16)
    pos[:, 1] = -3.5
    vel = np.zeros((16, 2), np.float32)
    vel[0] = (0.0, 240.0)   # ~10 rows per step: crosses several bands
    vel[1] = (120.0, 120.0)
    state = ParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.asarray(vel), density=jnp.ones(16),
        cell=jnp.zeros(16, jnp.uint32), tick=jnp.zeros((), jnp.uint32))

    spec = build_resident_spec(s, 8)
    mesh = make_resident_mesh(spec)
    step = make_sharded_resident_step(spec, mesh=mesh)
    gs0 = resident.from_particles(state, s)
    # shard the single-chip grid state by row band
    import jax as _jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    pad = spec.gy_pad - gs0.pos_x.shape[0]
    from tpufluid.ops.slot_physics import SENTINEL

    def padrow(a, fill):
        p = jnp.full((pad,) + a.shape[1:], fill, a.dtype)
        return jnp.concatenate([a, p], axis=0)

    shard = NamedSharding(mesh, P("x"))
    rep = NamedSharding(mesh, P())
    gs = resident.GridState(
        pos_x=_jax.device_put(padrow(gs0.pos_x, SENTINEL), shard),
        pos_y=_jax.device_put(padrow(gs0.pos_y, SENTINEL), shard),
        vel_x=_jax.device_put(padrow(gs0.vel_x, 0.0), shard),
        vel_y=_jax.device_put(padrow(gs0.vel_y, 0.0), shard),
        occ_row=_jax.device_put(padrow(gs0.occ_row, 0), shard),
        tick=_jax.device_put(gs0.tick, rep),
        lost=_jax.device_put(gs0.lost, rep),
    )
    params = TickParams.default(pressure_constant=0.0,
                                viscosity_coefficient=0.0)
    for _ in range(3):
        gs, stats = step(gs, params)
    assert int(np.asarray(stats["n_valid"]).sum()) == 16
    assert int(np.asarray(gs.lost)) == 0
    ps, live = gather_resident(gs, spec)
    assert int(live) == 16
    assert np.all(np.isfinite(np.asarray(ps.position)[:16]))


@pytest.mark.slow
@pytest.mark.parametrize("variant", [
    "surface_tension", "adaptive", "wrap", "forcefield"])
def test_resident_sharded_variants_match_single_chip(eight_devices, variant):
    """The sharded resident step carries the FULL variant surface of the
    single-chip engine (the reference's one engine does everything at
    once: compute.wgsl + shaders/compute.wgsl) — same kernels, same
    packing order => bitwise-equal positions per variant."""
    from tpufluid.ops import resident
    from tpufluid.parallel import (
        build_resident_spec, gather_resident, init_sharded_resident,
        make_resident_mesh, make_sharded_resident_step)

    s = SimSettings(particle_count=512, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(8.0, 8.0), cell_capacity=8,
                    texture_size=(80, 80))
    params = TickParams.default(gravity=(0.0, -9.8))
    kw = {}
    ff = None
    if variant == "surface_tension":
        kw["surface_tension"] = True
    elif variant == "adaptive":
        kw["adaptive_subsampling"] = True
    elif variant == "wrap":
        kw["x_boundary"] = "wrap"
        params = TickParams.default(gravity=(9.8, -2.0))
    elif variant == "forcefield":
        kw["has_force_field"] = True
        # constant per 2x2-texel cell => resident per-cell sampling is
        # exact (cf. test_resident.py cell-aligned field)
        f = np.zeros((80, 80, 2), np.float32)
        f[:, 50:, 0] = -3.0
        ff = jnp.asarray(f)

    spec = build_resident_spec(s, 8)
    mesh = make_resident_mesh(spec)
    step = make_sharded_resident_step(spec, mesh=mesh, **kw)
    gs = init_sharded_resident(spec, mesh=mesh)
    ref = resident.init_grid_state(s)
    rstep = resident.make_grid_step(
        s, **{k: v for k, v in kw.items()
              if k != "has_force_field"},
        has_force_field=ff is not None)
    for _ in range(4):
        if ff is not None:
            gs, stats = step(gs, params, ff)
            ref = rstep(ref, params, ff)
        else:
            gs, stats = step(gs, params)
            ref = rstep(ref, params)
    assert int(np.asarray(stats["n_valid"]).sum()) == 512
    assert int(np.asarray(gs.lost)) == 0
    ps, live = gather_resident(gs, spec)
    pr, liver = resident.to_particles(ref, s)
    assert int(live) == 512 and int(liver) == 512
    np.testing.assert_array_equal(
        sorted_points(np.asarray(ps.position)[:512]),
        sorted_points(np.asarray(pr.position)[:512]))


def test_resident_comm_volume_matches_model(eight_devices):
    """The documented comm volume (comm_audit.resident_comm_formula)
    must equal what the traced sharded step actually ships. Statically
    account every ppermute/all_gather in the traced step
    (parallel/comm_audit.py) and assert the per-direction bytes equal the
    documented formula: 3 rows x 4 f32 fields x [K, Gxp] (one packed
    boundary row + a two-row (pos, vel) halo) + the i32 occupancy rows.
    Any refactor that adds traffic fails here."""
    from tpufluid.parallel import (
        build_resident_spec, init_sharded_resident, make_resident_mesh,
        make_sharded_resident_step)
    from tpufluid.parallel import comm_audit

    s = SimSettings(particle_count=512, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(8.0, 8.0), cell_capacity=8)
    spec = build_resident_spec(s, 8)
    mesh = make_resident_mesh(spec)
    step = make_sharded_resident_step(spec, mesh=mesh)
    gs = init_sharded_resident(spec, mesh=mesh)
    audit = comm_audit.audit_step(step, gs, TickParams.default())
    model = comm_audit.resident_comm_formula(spec)

    assert audit["ppermute_bytes_per_dir"] == model["bytes_per_dir"]
    # the ONLY all_gather is the cond-gated far-mover packet
    assert audit["all_gather_bytes_unconditional"] == 0
    assert audit["all_gather_bytes_conditional"] == model["far_packet_bytes"]
    assert audit["ppermute_bytes_conditional"] == 0
    # per-step unconditional psums are scalar gates/ledgers, not payload
    for op in audit["ops"]:
        if op.primitive.startswith(("psum", "all_reduce")) \
                and not op.conditional:
            assert op.nbytes <= 8, op
