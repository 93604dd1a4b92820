"""Grid-resident engine (ops.resident): parity, rebin, far movers,
conversions. On the CPU the engine runs its plain jnp stages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from tpufluid import SimSettings, TickParams, init_state, make_step
from tpufluid.state import ParticleState
from tpufluid.ops import resident


def settings(n=256, cap=8):
    return SimSettings(particle_count=n, particle_spacing=0.1,
                       smoothing_radius=0.2, size=(6.0, 6.0),
                       cell_capacity=cap)


def sorted_pts(p):
    p = np.asarray(p)
    return p[np.lexsort((p[:, 1], p[:, 0]))]


def test_roundtrip_conversion():
    s = settings()
    state = init_state(s)
    gs = resident.from_particles(state, s)
    assert int(gs.lost) == 0
    ps, live = resident.to_particles(gs, s)
    assert int(live) == 256
    np.testing.assert_allclose(
        sorted_pts(ps.position), sorted_pts(state.position), atol=0)


@pytest.mark.slow
def test_resident_matches_dense_engine():
    s = settings()
    params = TickParams.default(gravity=(0.0, -9.8))
    gs = resident.init_grid_state(s)
    gstep = resident.make_grid_step(s)
    ref = init_state(s)
    rstep = make_step(s, neighbor_mode="dense")
    for i in range(3):
        gs = gstep(gs, params)
        ref = rstep(ref, params)
    assert int(gs.lost) == 0
    ps, live = resident.to_particles(gs, s)
    assert int(live) == 256
    # nearest-neighbor matching: lexsort pairing flips on roundoff-equal
    # coordinates, NN distance is the robust parity metric
    from scipy.spatial import cKDTree
    d, _ = cKDTree(np.asarray(ref.position)).query(
        np.asarray(ps.position)[:256])
    assert d.max() < 1e-5


@pytest.mark.slow
def test_far_movers_preserved():
    s = settings(n=16)
    pos = np.zeros((16, 2), np.float32)
    pos[:, 0] = np.linspace(-2.5, 2.5, 16)
    vel = np.zeros((16, 2), np.float32)
    vel[0] = (120.0, 60.0)  # ~5 cells per step: exercises the fallback
    state = ParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.asarray(vel), density=jnp.ones(16),
        cell=jnp.zeros(16, jnp.uint32), tick=jnp.zeros((), jnp.uint32))
    gs = resident.from_particles(state, s)
    step = resident.make_grid_step(s)
    params = TickParams.default(pressure_constant=0.0,
                                viscosity_coefficient=0.0)
    for _ in range(6):
        gs = step(gs, params)
    ps, live = resident.to_particles(gs, s)
    assert int(live) == 16
    assert int(gs.lost) == 0
    assert np.all(np.isfinite(np.asarray(ps.position)[:16]))


def test_capacity_overflow_is_counted_not_silent():
    # 32 particles stacked in one cell, capacity 2: most are lost at init
    s = settings(n=32, cap=2)
    pos = jnp.zeros((32, 2), jnp.float32)
    state = ParticleState(
        position=pos, predicted=pos, velocity=jnp.zeros((32, 2)),
        density=jnp.ones(32), cell=jnp.zeros(32, jnp.uint32),
        tick=jnp.zeros((), jnp.uint32))
    gs = resident.from_particles(state, s)
    assert int(gs.lost) == 30
    _, live = resident.to_particles(gs, s)
    assert int(live) == 2


@pytest.mark.slow
def test_multi_step_scan():
    s = settings(n=128)
    params = TickParams.default(gravity=(0.0, -9.8))
    run = resident.make_grid_multi_step(s, 4)
    gs = run(resident.init_grid_state(s), params)
    assert int(gs.tick) == 4
    assert int(gs.lost) == 0
    ps, live = resident.to_particles(gs, s)
    assert int(live) == 128
    p = np.asarray(ps.position)[:128]
    assert np.all(np.isfinite(p)) and p[:, 1].mean() < 0.0


@pytest.mark.slow
def test_resident_obstacle_matches_dense_on_cell_aligned_field():
    """Resident samples the force field per CELL; with a field that is
    constant within each cell (texels aligned 2-per-cell), both engines see
    identical values -> trajectories agree (compute.wgsl:127-140)."""
    s = SimSettings(particle_count=64, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(6.4, 6.4), cell_capacity=8,
                    texture_size=(64, 64))
    # field: texels in the right half push left by (-3, 0) pixels,
    # constant per 2x2-texel cell
    ff = np.zeros((64, 64, 2), np.float32)
    ff[:, 40:, 0] = -3.0
    ff = jnp.asarray(ff)
    params = TickParams.default(gravity=(2.0, 0.0))

    gs = resident.init_grid_state(s)
    gstep = resident.make_grid_step(s, has_force_field=True)
    ref = init_state(s)
    rstep = make_step(s, neighbor_mode="dense", has_force_field=True)
    for _ in range(6):
        gs = gstep(gs, params, ff)
        ref = rstep(ref, params, ff)
    assert int(gs.lost) == 0
    ps, live = resident.to_particles(gs, s)
    assert int(live) == 64
    from scipy.spatial import cKDTree
    d, _ = cKDTree(np.asarray(ref.position)).query(
        np.asarray(ps.position)[:64])
    assert d.max() < 1e-5


@pytest.mark.slow
def test_resident_obstacle_excludes_particles():
    """Qualitative: a circle obstacle expels particles from its interior
    (reference behavior of the push-out field, src/main.rs:495-511)."""
    from tpufluid.ops import forcefield as ffops

    s = SimSettings(particle_count=128, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(6.0, 6.0), cell_capacity=8,
                    texture_size=(64, 64))
    objects = ffops.Objects.from_list([("circle", (0.0, 0.0), 1.5)])
    field = ffops.obstacle_force_field(objects, s)
    gs = resident.init_grid_state(s)  # lattice overlaps the circle
    step = resident.make_grid_step(s, has_force_field=True)
    params = TickParams.default()
    for _ in range(8):
        gs = step(gs, params, field)
    ps, live = resident.to_particles(gs, s)
    p = np.asarray(ps.position)[: int(live)]
    r = np.linalg.norm(p, axis=1)
    # all particles pushed out (tolerance: one cell of sampling granularity)
    assert np.all(r > 1.5 - 0.25)


@pytest.mark.slow
def test_resident_wrap_boundary():
    """x_boundary='wrap' teleports across the x walls with velocity kept
    (shaders/compute.wgsl:145-146)."""
    s = settings(n=4)
    pos = np.array([[2.95, 0.0], [-2.95, 0.5], [0.0, 1.0], [0.5, 1.5]],
                   np.float32)
    vel = np.array([[30.0, 0.0], [-30.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
                   np.float32)
    state = ParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.asarray(vel), density=jnp.ones(4),
        cell=jnp.zeros(4, jnp.uint32), tick=jnp.zeros((), jnp.uint32))
    gs = resident.from_particles(state, s)
    step = resident.make_grid_step(s, x_boundary="wrap")
    params = TickParams.default(pressure_constant=0.0,
                                viscosity_coefficient=0.0)
    gs = step(gs, params)
    ps, live = resident.to_particles(gs, s)
    p = np.asarray(ps.position)[:4]
    v = np.asarray(ps.velocity)[:4]
    assert int(live) == 4
    crossed = p[np.argsort(p[:, 1])][:2]  # the two movers, by y
    assert crossed[0, 0] < 0.0 < crossed[1, 0]  # teleported to far wall
    assert np.abs(v).max() == 30.0  # velocity untouched by the wrap


def test_strict_capacity_refuses_undersized_scenes():
    """The round-1 failure mode: a gravity scene silently shed 99% of its
    mass at cell_capacity 8. FluidApp now refuses up front with a sizing
    message (the reference's unbounded loops never lose mass,
    compute.wgsl:182-229)."""
    from tpufluid.app import FluidApp
    from tpufluid.params import suggest_cell_capacity

    s = SimSettings(particle_count=16384, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(13.0, 26.0), cell_capacity=8)
    params = TickParams.default(gravity=(0.0, -9.8))
    need = suggest_cell_capacity(s, params)
    assert need > 8
    with pytest.raises(ValueError, match="cell_capacity"):
        FluidApp(s, params, neighbor_mode="resident",
                 capacity_policy="strict")
    # escape hatch: counted loss accepted explicitly
    app = FluidApp(s, params, neighbor_mode="resident",
                   strict_capacity=False)
    assert app is not None
    # the default policy ("grow") never refuses — reference semantics
    # (unbounded loops, compute.wgsl:182-229). It starts LEAN (spawn
    # lattice only, slot tiles cost rebin-output DMA) and relies on the
    # audit + regrow-and-replay backstop for the compression this
    # advisor models (test_capacity_grow_replays_lossless).
    app = FluidApp(s, params, neighbor_mode="resident")
    assert app.settings.cell_capacity == suggest_cell_capacity(s)
    # zero-gravity default passes at the same capacity
    ok = SimSettings(particle_count=256, particle_spacing=0.1,
                     smoothing_radius=0.2, size=(6.0, 6.0), cell_capacity=8)
    FluidApp(ok, TickParams.default(), neighbor_mode="resident")


@pytest.mark.slow
def test_capacity_grow_replays_lossless():
    """capacity_policy='grow': a live-tuned gravity spike that
    out-compresses the auto-sized capacity triggers regrow-and-replay —
    zero particles shed, and the trajectory is bitwise the
    always-big-capacity one (the reference's unbounded loops never shed,
    compute.wgsl:182-229)."""
    from tpufluid.app import FluidApp

    n = 384
    s = SimSettings(particle_count=n, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(4.8, 4.8), cell_capacity=8)
    app = FluidApp(s, TickParams.default(), neighbor_mode="resident")
    assert app.settings.cell_capacity == 8  # g=0: advisor keeps 8
    app.LOSS_CHECK_EVERY = 8  # tight audits: keep the test fast
    # live-tuned spike the advisor never saw: hard gravity + an injected
    # impact velocity so compression blows past K=8 within a few ticks
    st0 = dataclasses.replace(
        init_state(s), velocity=init_state(s).velocity.at[:, 1].add(-20.0))
    app.state = st0
    app.params.gravity = jnp.asarray([0.0, -60.0], jnp.float32)
    n_ticks = 24
    for _ in range(n_ticks):
        app.tick()
    m = app.metrics()
    assert m["lost_particles"] == 0
    assert app.settings.cell_capacity > 8  # it DID have to regrow
    assert int(app.state.position.shape[0]) == n
    assert np.all(np.isfinite(np.asarray(app.state.position)))

    # bitwise vs an always-big-capacity run (occupancy-driven kernels:
    # trajectory is capacity-independent while nothing is shed)
    big = dataclasses.replace(s, cell_capacity=app.settings.cell_capacity)
    ref = resident.from_particles(st0, big)
    rstep = resident.make_grid_step(big)
    params = TickParams.default(gravity=(0.0, -60.0))
    for _ in range(n_ticks):
        ref = rstep(ref, params)
    assert int(ref.lost) == 0
    pr, liver = resident.to_particles(ref, big)
    assert int(liver) == n
    got = np.asarray(app.state.position)
    want = np.asarray(pr.position)[:n]
    order = np.lexsort((got[:, 1], got[:, 0]))
    order_w = np.lexsort((want[:, 1], want[:, 0]))
    np.testing.assert_array_equal(got[order], want[order_w])


def test_shrink_hysteresis_logic():
    """Shrink-back decision logic without stepping (the stepped
    integration version is test_capacity_shrinks_back_after_transient,
    slow lane). The spawn
    lattice has occupancy 4, so audits see a calm scene: two clean
    audits reclaim the spare tile, never below the 8-slot floor, and
    occupancy near the boundary resets the streak (SHRINK_MARGIN)."""
    from tpufluid.app import FluidApp

    s = SimSettings(particle_count=128, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(3.2, 3.2), cell_capacity=16)
    app = FluidApp(s, TickParams.default(), neighbor_mode="resident")
    assert app.settings.cell_capacity == 16
    app._audit_loss()  # clean audit #1: streak, no shrink yet
    assert app.settings.cell_capacity == 16
    app._audit_loss()  # clean audit #2: shrink 16 -> 8
    assert app.settings.cell_capacity == 8
    assert app._grid_state.pos_x.shape[1] == 8
    app._audit_loss()
    app._audit_loss()  # 8 is the floor
    assert app.settings.cell_capacity == 8
    ps, live = resident.to_particles(app._grid_state, app.settings)
    assert int(live) == 128 and int(app._grid_state.lost) == 0

    # occupancy within SHRINK_MARGIN of the smaller capacity blocks the
    # shrink (and resets the streak): fake a row at occupancy 7 > 8-2
    app2 = FluidApp(s, TickParams.default(), neighbor_mode="resident")
    occ = np.asarray(app2._grid_state.occ_row).copy()
    occ[len(occ) // 2] = 7
    app2._grid_state = dataclasses.replace(
        app2._grid_state, occ_row=jnp.asarray(occ))
    for _ in range(6):
        app2._audit_loss()
    assert app2.settings.cell_capacity == 16


@pytest.mark.slow
def test_capacity_shrinks_back_after_transient():
    """capacity_policy='grow' shrink-back hysteresis: headroom left by a
    transient regrow (slot tiles cost real rebin-output DMA) is
    reclaimed once audits see sustained low occupancy — and the
    trajectory is bitwise the always-big-capacity one (shrink slices
    only sentinel tiles; kernels are occupancy-driven)."""
    from tpufluid.app import FluidApp

    n = 128
    s = SimSettings(particle_count=n, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(3.2, 3.2), cell_capacity=16)
    app = FluidApp(s, TickParams.default(), neighbor_mode="resident")
    assert app.settings.cell_capacity == 16  # user capacity kept
    app.LOSS_CHECK_EVERY = 4  # tight audits: keep the test fast
    n_ticks = 6 * 4  # enough audits for SHRINK_AFTER_AUDITS
    for _ in range(n_ticks):
        app.tick()
    m = app.metrics()
    assert m["lost_particles"] == 0
    # calm scene (occ0 = 4): two clean audits reclaim the spare tile
    assert app.settings.cell_capacity == 8
    assert int(app.state.position.shape[0]) == n

    ref = resident.from_particles(init_state(s), s)
    rstep = resident.make_grid_step(s)
    for _ in range(n_ticks):
        ref = rstep(ref, TickParams.default())
    pr, liver = resident.to_particles(ref, s)
    assert int(liver) == n
    got = np.asarray(app.state.position)
    want = np.asarray(pr.position)[:n]
    order = np.lexsort((got[:, 1], got[:, 0]))
    order_w = np.lexsort((want[:, 1], want[:, 0]))
    np.testing.assert_array_equal(got[order], want[order_w])


@pytest.mark.slow
def test_batched_worlds_match_single_world_steps():
    """B worlds stacked along the row axis (make_grid_step n_worlds=B) with
    per-world gravity step EXACTLY like B separate single-world runs
    (one kernel pass, no vmap)."""
    s = SimSettings(particle_count=128, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(6.0, 6.0), cell_capacity=8)
    B = 3
    plist = [TickParams.default(gravity=(0.0, -g)) for g in (0.0, 4.9, 9.8)]
    gs = resident.init_batched_grid_state(s, B)
    step = resident.make_grid_step(s, n_worlds=B)
    bp = resident.batched_params(plist)
    for _ in range(4):
        gs = step(gs, bp)
    assert int(gs.lost) == 0
    rstep = resident.make_grid_step(s)
    for w in range(B):
        ref = resident.init_grid_state(s)
        for _ in range(4):
            ref = rstep(ref, plist[w])
        ps, live = resident.to_particles(
            resident.world_state(gs, s, w), s)
        pr, liver = resident.to_particles(ref, s)
        assert int(live) == 128 and int(liver) == 128
        np.testing.assert_array_equal(
            np.sort(np.asarray(ps.position)[:128], axis=0),
            np.sort(np.asarray(pr.position)[:128], axis=0))


@pytest.mark.slow
def test_batched_worlds_with_force_field_match_single_runs():
    """Batched + obstacles together: B
    worlds with DIFFERENT per-world obstacle fields step exactly like B
    separate single-world runs with those fields."""
    from tpufluid.ops import forcefield as ffops

    s = SimSettings(particle_count=64, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(6.0, 6.0), cell_capacity=8,
                    texture_size=(64, 64))
    B = 2
    fields = [
        ffops.obstacle_force_field(
            ffops.Objects.from_list([("circle", (0.0, -1.0), 1.2)]), s),
        ffops.obstacle_force_field(
            ffops.Objects.from_list([("rect", (1.0, 0.0), (1.0, 2.0))]), s),
    ]
    plist = [TickParams.default(gravity=(0.0, -2.0))] * B
    gs = resident.init_batched_grid_state(s, B)
    step = resident.make_grid_step(s, n_worlds=B, has_force_field=True)
    bp = resident.batched_params(plist)
    ff = jnp.stack(fields)
    for _ in range(4):
        gs = step(gs, bp, ff)
    assert int(gs.lost) == 0
    rstep = resident.make_grid_step(s, has_force_field=True)
    for w in range(B):
        ref = resident.init_grid_state(s)
        for _ in range(4):
            ref = rstep(ref, plist[w], fields[w])
        ps, live = resident.to_particles(
            resident.world_state(gs, s, w), s)
        pr, liver = resident.to_particles(ref, s)
        assert int(live) == 64 and int(liver) == 64
        np.testing.assert_array_equal(
            np.sort(np.asarray(ps.position)[:64], axis=0),
            np.sort(np.asarray(pr.position)[:64], axis=0))


def test_batched_requires_shared_delta():
    s = settings(n=16)
    plist = [TickParams.default(delta=1 / 120), TickParams.default(delta=1 / 60)]
    with pytest.raises(ValueError, match="delta"):
        resident.batched_params(plist)


def test_batched_world_stats():
    """Per-world occupancy metrics: identical worlds report identical
    stats; mass accounting is per world; after stepping with differing
    gravity the counts stay exact, and the g = 9.8 world, which has
    settled on the floor after 200 steps (1.7 s), piles into fewer rows
    at a higher occupancy than the zero-gravity world, which spreads out.
    Early steps differ only slightly between the worlds, so the signal
    is taken late, where it does not rest on f32 summation order."""
    s = SimSettings(particle_count=128, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(6.0, 6.0), cell_capacity=8)
    B = 3
    gs = resident.init_batched_grid_state(s, B)
    st = resident.batched_world_stats(gs, s, B)
    assert st["particles"] == [128] * B
    assert st["occupied_rows"][0] > 0
    for key in ("occupied_rows", "rowmax_mean", "rowmax_max", "occ3_mean"):
        assert st[key] == [st[key][0]] * B, key

    plist = [TickParams.default(gravity=(0.0, -g)) for g in (0.0, 4.9, 9.8)]
    run = resident.make_grid_multi_step(s, 200, n_worlds=B)
    gs = run(gs, resident.batched_params(plist))
    st2 = resident.batched_world_stats(gs, s, B)
    assert st2["particles"] == [128] * B
    assert 2 * st2["occupied_rows"][2] < st2["occupied_rows"][0]
    assert st2["rowmax_max"][2] > st2["rowmax_max"][0]


def test_capacity_sliced_dispatch_matches_dense():
    """cell_capacity 16 with occupancy straddling the 8-slot tile (two
    slot tiles of the GPU kernels): the resident engine must agree with
    the dense engine and conserve mass as occupancy crosses the tile
    boundary."""
    from scipy.spatial import cKDTree

    n = 64
    s = SimSettings(particle_count=n, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(3.4, 3.4), cell_capacity=16)
    rng = np.random.default_rng(3)
    # 12 particles piled into one cell (occ 12 > one 8-slot
    # tile), the rest spread out (occ <= 4); the pile disperses over the
    # steps so occupancy crosses back under the tile boundary
    pos = np.zeros((n, 2), np.float32)
    pos[:12] = rng.uniform(-0.05, 0.05, (12, 2)) + [1.0, 1.0]
    pos[12:] = rng.uniform(-1.5, 1.5, (n - 12, 2))
    vel = np.zeros((n, 2), np.float32)
    state = ParticleState(
        position=jnp.asarray(pos), predicted=jnp.asarray(pos),
        velocity=jnp.asarray(vel), density=jnp.ones(n),
        cell=jnp.zeros(n, jnp.uint32), tick=jnp.zeros((), jnp.uint32))
    params = TickParams.default(gravity=(0.0, -2.0))

    gs = resident.from_particles(state, s)
    gstep = resident.make_grid_step(s)
    ref = state
    rstep = make_step(s, neighbor_mode="dense")
    for _ in range(6):
        gs = gstep(gs, params)
        ref = rstep(ref, params)
    assert int(gs.lost) == 0
    ps, live = resident.to_particles(gs, s)
    assert int(live) == n
    d, _ = cKDTree(np.asarray(ref.position)).query(
        np.asarray(ps.position)[:n])
    assert d.max() < 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("variant_kw", [
    dict(x_boundary="wrap"),
    dict(surface_tension=True),
    dict(adaptive_subsampling=True),
], ids=["wrap", "surface-tension", "adaptive"])
def test_batched_worlds_variants_match_single_runs(variant_kw):
    """The forked-shader variants
    (x-wrap / surface tension / adaptive subsampling,
    /root/reference/shaders/compute.wgsl + compute.wgsl:303-498) on
    BATCHED row-stacked worlds (n_worlds=3) step exactly like three
    separate single-world runs with the same flags."""
    s = SimSettings(particle_count=96, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(5.0, 5.0), cell_capacity=8)
    B = 3
    extra = {}
    if variant_kw.get("surface_tension"):
        extra = dict(surface_tension_threshold=0.05,
                     surface_tension_coefficient=5.0)
    plist = [TickParams.default(gravity=(0.3 * w, -4.9 * w), **extra)
             for w in range(B)]
    gs = resident.init_batched_grid_state(s, B)
    step = resident.make_grid_step(s, n_worlds=B, **variant_kw)
    bp = resident.batched_params(plist)
    for _ in range(4):
        gs = step(gs, bp)
    assert int(gs.lost) == 0
    rstep = resident.make_grid_step(s, **variant_kw)
    for w in range(B):
        ref = resident.init_grid_state(s)
        for _ in range(4):
            ref = rstep(ref, plist[w])
        ps, live = resident.to_particles(
            resident.world_state(gs, s, w), s)
        pr, liver = resident.to_particles(ref, s)
        assert int(live) == 96 and int(liver) == 96
        got = np.sort(np.asarray(ps.position)[:96], axis=0)
        want = np.sort(np.asarray(pr.position)[:96], axis=0)
        np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_resident_obstacle_error_bound_on_non_aligned_field():
    """Quantify the resident engine's
    cell-granular force-field sampling error on a deliberately
    NON-cell-aligned field (a circle at an off-lattice center), vs the
    dense engine's exact per-texel sampling (compute.wgsl:127-140).

    Texel/cell ratio mirrors the reference defaults (1024 texels over a
    53-world box -> ~19.3 texels/world; here 128 over 6.6): the sampling
    point can be off by up to half a cell (~2 texels), so the documented
    claim (ops/resident.py module docstring) is a SUB-CELL per-step
    error. Engines are re-synced to the dense state every step so the
    measurement is per-step sampling error, not chaotic divergence."""
    from scipy.spatial import cKDTree
    from tpufluid.ops import forcefield as ffops

    s = SimSettings(particle_count=64, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(6.6, 6.6), cell_capacity=8,
                    texture_size=(128, 128))
    # circle center deliberately off any cell or texel boundary; it
    # grazes the spawn block (which spans +-0.4) so particles sit in the
    # smooth near-boundary region of the push-out field, not the medial
    # axis
    objects = ffops.Objects.from_list([("circle", (1.07, 0.23), 0.83)])
    field = ffops.obstacle_force_field(objects, s)

    rstep = make_step(s, neighbor_mode="dense", has_force_field=True)
    gstep = resident.make_grid_step(s, has_force_field=True)
    params = TickParams.default(gravity=(1.5, 0.0))  # drift into the circle

    ref = init_state(s)
    max_dev = 0.0
    for _ in range(6):
        prev = ref
        ref = rstep(prev, params, field)
        gs = gstep(resident.from_particles(prev, s), params, field)
        assert int(gs.lost) == 0
        ps, live = resident.to_particles(gs, s)
        assert int(live) == 64
        d, _ = cKDTree(np.asarray(ref.position)).query(
            np.asarray(ps.position)[:64])
        max_dev = max(max_dev, float(d.max()))
    # the approximation is real on a non-aligned field...
    assert max_dev > 0.0
    # ...and stays sub-cell per step (measured ceiling; h = 0.2)
    assert max_dev < s.smoothing_radius, max_dev


@pytest.mark.slow
def test_acceptance_window_grow_policy_first_audit():
    """Cover of the unbounded-capacity acceptance scene's SHAPE — a spawn lattice
    free-falling under g=(0, -9.8) onto the floor, capacity_policy="grow"
    — run through the first full 256-tick runtime audit window (the real
    LOSS_CHECK_EVERY, not a shortened one) via the burst path. Nothing
    may be shed, the audit bookkeeping must have fired, and the regrow
    counter must be reported."""
    from tpufluid.app import FluidApp

    n = 256
    s = SimSettings(particle_count=n, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(4.8, 4.8), cell_capacity=8)
    app = FluidApp(s, TickParams.default(gravity=(0.0, -9.8)),
                   neighbor_mode="resident", capacity_policy="grow")
    assert app.LOSS_CHECK_EVERY == 256
    app.run(260, max_burst=32)  # > one audit window
    m = app.metrics()
    assert m["tick"] == 260
    assert m["lost_particles"] == 0
    assert m["n_regrows"] >= 0  # reported (0 is fine: advisor pre-sized)
    assert m["cell_capacity"] == app.settings.cell_capacity
    assert app._ticks_since_audit == 4  # the 256-tick audit DID run
    deep = app.metrics(deep=True)
    assert deep["nan_positions"] == 0 and deep["nan_velocities"] == 0
    assert deep["out_of_bounds"] == 0
