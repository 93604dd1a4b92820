"""Grid-resident engine: particles live in the cell grid between steps.

The [N]-array engines re-sort, re-scatter and re-gather the whole particle
set every step. Here the state IS the dense slot grid [Gy, K, Gxp]
(K = cell_capacity, minor dim = grid x), and each step is:

  1. rebin: slots move to their new cells (local moves only), emitting
     per-row occupancy/far/overflow counts (ops.slot_physics.rebin);
  2. far movers (> 1 cell/step, rare) re-insert through a sort-based
     fallback under ``lax.cond`` (costs nothing when there are none);
  3. density -> (pressure, 1/rho);
  4. forces fused with the FULL integration (gravity, mouse impulse, NaN
     reset, speed clamp, obstacle force field, boundary bounce/wrap) --
     compute.wgsl:59-299 + 95-155 in two stages, no elementwise passes.

Stages 3 and 4 run as Triton kernels on an NVIDIA GPU
(ops.pallas.triton_resident) and as the plain jnp stages of
ops.slot_physics on the CPU; ``physics_impl`` chooses from the backend.

Empty slots hold position = SENTINEL (no valid mask -- exclusion falls
out of the range test); ``occ_row`` carries per-row packed occupancy so
the physics loops run over occupied candidate slots only.

Semantics match the [N] engines: re-binning keys are the clamped predicted
positions, neighbor sets are identical; candidate iteration order is
(slot, row, dx) and within-cell packing order is (source row, dx, slot),
so results agree to f32 reduction order (tests/test_resident.py).

Capacity rules: arrivals beyond cell_capacity and far movers beyond
``far_capacity`` are dropped and COUNTED in ``GridState.lost`` -- never
silent. Keep cell_capacity at ~2x rest occupancy (params.SimSettings).

Obstacle force fields are supported at CELL granularity: one push-out
vector per grid cell (sampled at the cell center), vs the reference's
per-particle texel fetch (compute.wgsl:127-132). At defaults a cell spans
~2 texels, so the approximation error is sub-cell; use
neighbor_mode='dense' when per-texel sampling matters.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..params import SimSettings, TickParams
from ..state import ParticleState, init_state
from . import grid as gridops
from . import slot_physics
from .dense import build_grid_cols
from .slot_physics import SENTINEL, SENTINEL_HALF


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GridState:
    """pos/vel slot grids [Gy, K, Gxp] (empty slots at pos=SENTINEL),
    per-row packed occupancy i32[Gy], tick, cumulative lost counter."""

    pos_x: jax.Array
    pos_y: jax.Array
    vel_x: jax.Array
    vel_y: jax.Array
    occ_row: jax.Array
    tick: jax.Array
    lost: jax.Array


def _gxp(settings: SimSettings) -> int:
    """Grid width padded to a multiple of 128 columns (the pad columns stay
    empty). Every Triton program of ops.pallas.triton_resident then covers
    a whole tile of 64 or 128 columns inside the array, so target loads
    and stores need no column mask."""
    return -(-settings.grid_w // 128) * 128


def pad_capacity(settings: SimSettings) -> SimSettings:
    """Round cell_capacity up to a power of two up to 8, and to a multiple
    of 8 above: the Triton kernels tile the slot axis in min(K, 8) slots,
    a power-of-two block that must divide K. Extra capacity never loses
    mass; the user contract is a minimum."""
    k = settings.cell_capacity
    k_pad = 1 << (k - 1).bit_length() if k <= 8 else -(-k // 8) * 8
    if k_pad == k:
        return settings
    return dataclasses.replace(settings, cell_capacity=k_pad)


def physics_impl(platform: Optional[str] = None) -> str:
    """The physics implementation for a JAX backend: ``"triton"`` (the
    compiled GPU kernels) on ``"gpu"``, ``"plain"`` (ops.slot_physics) on
    ``"cpu"``. Any other platform is an error; nothing falls back."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "plain"
    raise RuntimeError(
        f"the resident engine has no physics for platform {platform!r} "
        "(supported: gpu, cpu)")


def physics_stages(impl: str):
    """(density, forces_integrate) of ``impl`` (see physics_impl)."""
    if impl == "triton":
        from .pallas import triton_resident
        return (functools.partial(triton_resident.density, interpret=False),
                functools.partial(triton_resident.forces_integrate,
                                  interpret=False))
    if impl == "plain":
        return slot_physics.density, slot_physics.forces_integrate
    raise ValueError(f"unknown physics implementation {impl!r}")


def valid_mask(gs: GridState) -> jax.Array:
    """bool[Gy, K, Gxp]: which slots hold a live particle."""
    return gs.pos_x < SENTINEL_HALF


def occ_row_of(pos_x: jax.Array) -> jax.Array:
    """Per-row max packed occupancy, recomputed from a sentinel grid."""
    occ_cell = jnp.sum((pos_x < SENTINEL_HALF).astype(jnp.int32), axis=1)
    return jnp.max(occ_cell, axis=1)


def from_particles(state: ParticleState, settings: SimSettings) -> GridState:
    """Bin a ParticleState into the resident grid (boundary conversion)."""
    settings = pad_capacity(settings)
    cells = gridops.cell_id(state.predicted, settings)
    binning = gridops.bin_particles(cells, settings)
    src = jnp.concatenate([state.position, state.velocity], axis=1)
    g4 = src[binning.perm]
    grid = build_grid_cols(
        g4[:, 0], g4[:, 1], g4[:, 2], g4[:, 3], binning.sorted_cells,
        settings, dims=(settings.grid_h, settings.grid_w))
    px = jnp.where(grid.valid, grid.px, SENTINEL)
    py = jnp.where(grid.valid, grid.py, SENTINEL)
    return GridState(
        pos_x=px, pos_y=py, vel_x=grid.vx, vel_y=grid.vy,
        occ_row=occ_row_of(px),
        tick=state.tick, lost=grid.n_dropped,
    )


def init_grid_state(settings: SimSettings) -> GridState:
    return from_particles(init_state(settings), settings)


def grow_capacity(gs: GridState, new_k: int) -> GridState:
    """Widen the slot axis to ``new_k`` (appending sentinel slots).

    Arrivals pack into slots 0..count-1, so appending empties preserves
    every packing invariant; occupancy and the physics trajectory are
    unchanged (kernel cost tracks occupancy, not capacity). This is the
    cheap half of FluidApp's regrow-and-replay answer to the reference's
    unbounded per-cell loops (compute.wgsl:182-229): headroom costs only
    memory, never compute."""
    gy, k, gxp = gs.pos_x.shape
    if new_k % 8 != 0:
        raise ValueError(f"new_k {new_k} must be a multiple of 8")
    if new_k <= k:
        return gs
    pad_s = jnp.full((gy, new_k - k, gxp), SENTINEL, jnp.float32)
    pad_z = jnp.zeros((gy, new_k - k, gxp), jnp.float32)
    cat = lambda a, p: jnp.concatenate([a, p], axis=1)
    return dataclasses.replace(
        gs, pos_x=cat(gs.pos_x, pad_s), pos_y=cat(gs.pos_y, pad_s),
        vel_x=cat(gs.vel_x, pad_z), vel_y=cat(gs.vel_y, pad_z))


def shrink_capacity(gs: GridState, new_k: int) -> GridState:
    """Narrow the slot axis to ``new_k`` (dropping trailing slot tiles).

    Exact only when every row's occupancy is <= ``new_k``: arrivals pack
    into slots 0..count-1, so the trailing tiles hold only sentinels and
    slicing them off loses nothing (the caller — FluidApp's shrink-back
    hysteresis — checks max occupancy first). The inverse of
    ``grow_capacity``: slot tiles cost no pair work (the physics loops
    stop at the occupancy) but the rebin reads and writes all ``K``
    slots, so sustained headroom is worth reclaiming after a
    transient-compression regrow."""
    gy, k, gxp = gs.pos_x.shape
    if new_k % 8 != 0:
        raise ValueError(f"new_k {new_k} must be a multiple of 8")
    if new_k >= k:
        return gs
    sl = lambda a: a[:, :new_k, :]
    return dataclasses.replace(
        gs, pos_x=sl(gs.pos_x), pos_y=sl(gs.pos_y),
        vel_x=sl(gs.vel_x), vel_y=sl(gs.vel_y))


def to_particles(gs: GridState, settings: SimSettings) -> Tuple[ParticleState, jax.Array]:
    """(ParticleState, live_count). Slots beyond the live count are zeroed;
    arrays are sized to settings.particle_count."""
    n = settings.particle_count
    size = gs.pos_x.size
    gxp = gs.pos_x.shape[-1]
    k = gs.pos_x.shape[1]
    slot = jnp.arange(size, dtype=jnp.int32)
    cy = slot // (k * gxp)
    cx = slot % gxp
    cell = cy * settings.grid_w + cx
    valid = valid_mask(gs).reshape(-1)
    key = jnp.where(valid, cell, jnp.int32(settings.num_cells + 1))
    _, perm = lax.sort_key_val(key, slot, is_stable=True)
    sel = perm[:n]
    live = jnp.sum(valid.astype(jnp.int32))
    ok = jnp.arange(n) < live
    fields = jnp.stack(
        [gs.pos_x.reshape(-1), gs.pos_y.reshape(-1),
         gs.vel_x.reshape(-1), gs.vel_y.reshape(-1)], axis=1)[sel]
    fields = jnp.where(ok[:, None], fields, 0.0)
    cells_out = jnp.where(ok, key[perm[:n]], 0).astype(jnp.uint32)
    pos = fields[:, 0:2]
    return ParticleState(
        position=pos, predicted=pos, velocity=fields[:, 2:4],
        density=jnp.zeros((n,), jnp.float32), cell=cells_out, tick=gs.tick,
    ), live


def forcefield_cells(forcefield: jax.Array, settings: SimSettings,
                     gxp: Optional[int] = None, row_start=0,
                     n_rows: Optional[int] = None):
    """Sample the [H, W, 2] pixel push-out field at grid-cell centers.

    Returns (ffx, ffy) f32[Gy, Gxp] PIXEL-space vectors (the kernel scales
    the position push to world units and normalizes in pixel space, like
    compute.wgsl:127-140). The sentinel ring and pad columns are zeroed.

    ``row_start``/``n_rows``: global-row window for sharded slabs (may be
    traced).
    """
    gy, gw = settings.grid_h, settings.grid_w
    n_rows = n_rows if n_rows is not None else gy
    gxp = gxp if gxp is not None else _gxp(settings)
    h = settings.smoothing_radius
    half = jnp.asarray(settings.size, jnp.float32) * 0.5
    tex_w, tex_h = settings.texture_size
    # world coords of cell centers; cell index c covers
    # [(c-1)*h - half, c*h - half) (ops.grid.cell_xy inverse)
    rows = row_start + jnp.arange(n_rows, dtype=jnp.int32)
    wx = (jnp.arange(gxp, dtype=jnp.float32) - 0.5) * h - half[0]
    wy = (rows.astype(jnp.float32) - 0.5) * h - half[1]
    # texel per sample_force_field (step.py): uv = p/size + 0.5
    tx = jnp.clip(((wx / (2.0 * half[0]) + 0.5) * tex_w).astype(jnp.int32),
                  0, tex_w - 1)
    ty = jnp.clip(((wy / (2.0 * half[1]) + 0.5) * tex_h).astype(jnp.int32),
                  0, tex_h - 1)
    f = forcefield[ty[:, None], tx[None, :]]  # [n_rows, Gxp, 2]
    in_x = (jnp.arange(gxp) >= 1) & (jnp.arange(gxp) <= gw - 2)
    in_y = (rows >= 1) & (rows <= gy - 2)
    mask = (in_y[:, None] & in_x[None, :]).astype(jnp.float32)
    return f[..., 0] * mask, f[..., 1] * mask


def make_grid_step(settings: SimSettings, far_capacity: int | None = None,
                   x_boundary: str = "bounce",
                   has_force_field: bool = False,
                   surface_tension: bool = False,
                   adaptive_subsampling: bool = False,
                   n_worlds: int = 1, impl: Optional[str] = None):
    """Jitted resident step: ``step(gs, params[, forcefield]) -> GridState``.

    ``impl``: the physics implementation (see physics_impl), by default
    the backend's own; the benchmark and the GPU checks pass "plain" to
    compare the Triton kernels with what XLA makes of the plain stages.

    Memoized on all (hashable) arguments: FluidApp's capacity
    regrow/shrink hysteresis rebuilds steps as it moves between
    capacities, and without the cache every move back to an
    already-compiled capacity re-traced and re-compiled the kernels
    (jax.jit caches per function INSTANCE; each call here used to mint a
    fresh closure).

    CAPACITY SIZING MATTERS under gravity: the EOS p = k*rho makes a fluid
    column of height H compress ~exp(g*H/k) at the floor; cell_capacity
    must cover rest_occupancy * that factor or mass is shed (counted in
    GridState.lost). See SimSettings.cell_capacity guidance.
    """
    if x_boundary not in ("bounce", "wrap"):
        raise ValueError(f"unknown x_boundary {x_boundary!r}")
    impl = impl or physics_impl()
    key = (settings, far_capacity, x_boundary, has_force_field,
           surface_tension, adaptive_subsampling, n_worlds, impl)
    hit = _STEP_CACHE.get(key)
    if hit is not None:
        return hit
    density, forces_integrate = physics_stages(impl)
    settings = pad_capacity(settings)
    gxp = _gxp(settings)
    k = settings.cell_capacity
    gy = settings.grid_h
    grid_w = settings.grid_w
    gy_total = gy * n_worlds
    h_inv = 1.0 / settings.smoothing_radius
    if far_capacity is None:
        # impact phases can fling thousands of >1-cell movers in one step
        far_capacity = max(4096, (gy_total * k * gxp) // 128)
    # batched world stacks: each world's grid rows already end in the
    # empty sentinel ring, so worlds stack directly along the row axis
    # with zero cross-talk; only the cell-row frame of each row
    # (row_offset) and the per-world scalar lookup (wid) change.
    if n_worlds > 1:
        wid = jnp.repeat(jnp.arange(n_worlds, dtype=jnp.int32), gy)
        row_offset = -(wid * gy)
    else:
        wid = None
        row_offset = 0

    def step(gs: GridState, params: TickParams,
             forcefield: Optional[jax.Array] = None) -> GridState:
        frame = gs.tick + jnp.uint32(1)
        dt = params.delta
        if n_worlds > 1 and dt.ndim != 0:
            raise ValueError(
                "batched resident mode shares one delta across worlds "
                "(pass a scalar); gravity/viscosity/etc. may be [B]")

        # 1. re-bin by next predicted cell (local moves)
        px, py, vx, vy, occ_row, far_n, over_n = slot_physics.rebin(
            gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, dt, settings,
            row_offset=row_offset)
        n_far = jnp.sum(far_n)
        n_over = jnp.sum(over_n)

        # 2. far movers (rare): recompute their targets and re-insert.
        # All the heavy mask math lives INSIDE the cond branch.
        def do_far(ops):
            px, py, vx, vy, occ_row = ops
            half = jnp.asarray(settings.size, jnp.float32) * 0.5
            prx = jnp.clip(gs.pos_x + gs.vel_x * dt, -half[0], half[0])
            pry = jnp.clip(gs.pos_y + gs.vel_y * dt, -half[1], half[1])
            # interior clamp mirrors ops.grid.cell_xy / the rebin
            ncx = jnp.clip(
                jnp.floor((prx + half[0]) * h_inv).astype(jnp.int32) + 1,
                1, grid_w - 2)
            ncy = jnp.clip(
                jnp.floor((pry + half[1]) * h_inv).astype(jnp.int32) + 1,
                1, gy - 2)
            scx = jax.lax.broadcasted_iota(jnp.int32, gs.pos_x.shape, 2)
            scy = jax.lax.broadcasted_iota(jnp.int32, gs.pos_x.shape, 0)
            if n_worlds > 1:
                # world-local cell row -> absolute stacked row
                ncy = ncy + (scy // gy) * gy
            far = (gs.pos_x < SENTINEL_HALF) & (
                (jnp.abs(ncy - scy) > 1) | (jnp.abs(ncx - scx) > 1))
            far_flat = far.reshape(-1)
            size = px.size
            sort_key = jnp.where(far_flat, 0, 1).astype(jnp.int32)
            _, perm = lax.sort_key_val(
                sort_key, jnp.arange(size, dtype=jnp.int32), is_stable=True)
            sel = perm[:far_capacity]
            ok = jnp.arange(far_capacity, dtype=jnp.int32) < n_far
            rows = jnp.stack(
                [gs.pos_x.reshape(-1), gs.pos_y.reshape(-1),
                 gs.vel_x.reshape(-1), gs.vel_y.reshape(-1),
                 ncx.reshape(-1).astype(jnp.float32),
                 ncy.reshape(-1).astype(jnp.float32)], axis=1)[sel]
            tcx = rows[:, 4].astype(jnp.int32)
            tcy = rows[:, 5].astype(jnp.int32)
            # order by target cell for in-cell ranking
            tcell = jnp.where(ok, tcy * grid_w + tcx, jnp.int32(2**30))
            tcell_s, perm2 = lax.sort_key_val(
                tcell, jnp.arange(far_capacity, dtype=jnp.int32),
                is_stable=True)
            rows = rows[perm2]
            ok = ok[perm2]
            from .dense import ranks
            rank = ranks(tcell_s)
            occ_cell = jnp.sum(
                (px < SENTINEL_HALF).astype(jnp.int32), axis=1)  # [Gy, Gxp]
            cy2 = jnp.clip(tcell_s // grid_w, 0, gy_total - 1)
            cx2 = jnp.clip(tcell_s % grid_w, 0, gxp - 1)
            base = occ_cell.reshape(-1)[cy2 * gxp + cx2]
            slot = base + rank
            fits = ok & (slot < k)
            flat = jnp.where(fits, (cy2 * k + slot) * gxp + cx2, size)
            px = px.reshape(-1).at[flat].set(
                rows[:, 0], mode="drop").reshape(px.shape)
            py = py.reshape(-1).at[flat].set(
                rows[:, 1], mode="drop").reshape(py.shape)
            vx_ = vx.reshape(-1).at[flat].set(
                rows[:, 2], mode="drop").reshape(vx.shape)
            vy_ = vy.reshape(-1).at[flat].set(
                rows[:, 3], mode="drop").reshape(vy.shape)
            dropped = n_far - jnp.sum(fits.astype(jnp.int32))
            return px, py, vx_, vy_, occ_row_of(px), dropped

        px, py, vx, vy, occ_row, far_dropped = lax.cond(
            n_far > 0,
            do_far,
            lambda ops: (*ops, jnp.int32(0)),
            (px, py, vx, vy, occ_row),
        )

        # 3. physics: density -> (pressure, 1/rho) -> forces + integration
        ff_cells = None
        if has_force_field:
            if forcefield is None:
                raise ValueError("step built with has_force_field=True "
                                 "needs a forcefield argument")
            if n_worlds > 1:
                # per-world [W, H, Wtex, 2] (or one shared [H, Wtex, 2])
                # field; each world's cell samples stack along the row
                # axis like the state rows do
                ff = forcefield
                if ff.ndim == 3:
                    ff = jnp.broadcast_to(ff, (n_worlds,) + ff.shape)
                parts = [forcefield_cells(ff[w], settings, gxp,
                                          n_rows=gy)
                         for w in range(n_worlds)]
                ff_cells = (jnp.concatenate([p[0] for p in parts]),
                            jnp.concatenate([p[1] for p in parts]))
            else:
                ff_cells = forcefield_cells(forcefield, settings, gxp,
                                            n_rows=gy)

        pres, invr = density(
            px, py, vx, vy, occ_row, params.mass, dt,
            params.pressure_constant, params.rest_density, settings,
            wid=wid)
        npx, npy, nvx, nvy = forces_integrate(
            px, py, vx, vy, pres, invr, occ_row, params, settings,
            frame, ff_cells=ff_cells, x_boundary=x_boundary,
            surface_tension=surface_tension,
            adaptive_subsampling=adaptive_subsampling, wid=wid)

        return GridState(
            pos_x=npx, pos_y=npy, vel_x=nvx, vel_y=nvy,
            occ_row=occ_row,  # packing unchanged by integration
            tick=frame,
            lost=gs.lost + n_over + far_dropped,
        )

    if has_force_field:
        fn = jax.jit(step)
    else:
        fn = jax.jit(lambda gs, params: step(gs, params, None))
    _STEP_CACHE[key] = fn
    return fn


_STEP_CACHE: dict = {}
_MULTI_STEP_CACHE: dict = {}


def make_grid_multi_step(settings: SimSettings, n_steps: int, **kw):
    """``run(gs, params[, forcefield])``: ``n_steps`` resident steps under
    one ``lax.scan`` (one device dispatch). Memoized like
    ``make_grid_step``."""
    key = (settings, n_steps, tuple(sorted(kw.items())))
    hit = _MULTI_STEP_CACHE.get(key)
    if hit is not None:
        return hit
    has_ff = kw.get("has_force_field", False)
    step = make_grid_step(settings, **kw)

    if has_ff:
        @jax.jit
        def run(gs, params, forcefield):
            def body(s, _):
                return step(s, params, forcefield), None
            out, _ = lax.scan(body, gs, None, length=n_steps)
            return out
    else:
        @jax.jit
        def run(gs, params):
            def body(s, _):
                return step(s, params), None
            out, _ = lax.scan(body, gs, None, length=n_steps)
            return out
    _MULTI_STEP_CACHE[key] = run
    return run


# ------------------------------------------------------------- batching
# Batched sweeps: B independent worlds with differing per-tick params,
# stepped by ONE set of kernels. Worlds stack along the grid-row
# axis (each world's sentinel ring separates it from its neighbors), so
# kernel cost scales with total rows — no vmap, no per-world dispatch.

def init_batched_grid_state(settings: SimSettings,
                            n_worlds: int) -> GridState:
    """The reference spawn lattice replicated into a B-world row stack."""
    gs = init_grid_state(settings)
    return GridState(
        pos_x=jnp.tile(gs.pos_x, (n_worlds, 1, 1)),
        pos_y=jnp.tile(gs.pos_y, (n_worlds, 1, 1)),
        vel_x=jnp.tile(gs.vel_x, (n_worlds, 1, 1)),
        vel_y=jnp.tile(gs.vel_y, (n_worlds, 1, 1)),
        occ_row=jnp.tile(gs.occ_row, (n_worlds,)),
        tick=gs.tick, lost=gs.lost,
    )


def batched_params(param_list) -> TickParams:
    """Stack B TickParams into one with a leading [B] dim on every field
    EXCEPT delta, which must be shared (scalar) across worlds."""
    import numpy as _np
    d0 = _np.asarray(param_list[0].delta)
    for p in param_list[1:]:
        if not _np.array_equal(_np.asarray(p.delta), d0):
            raise ValueError("batched worlds must share delta")
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *param_list)
    stacked.delta = param_list[0].delta
    return stacked


def batched_world_stats(gs: GridState, settings: SimSettings,
                        n_worlds: int) -> dict:
    """Per-world occupancy/row metrics for a batched row stack.

    The physics kernels' cost scales with occupied rows x occ3 (candidate
    slots scanned), so per-world variance here IS the batched-vs-single
    throughput gap: the stacked kernels pay every
    world's row count at that world's occupancy, and a world whose fluid
    spreads over more rows or compresses to higher occ3 costs more than
    the single-scene equivalent. Returns plain Python lists (one entry
    per world): particle count, occupied rows, per-row max occupancy
    (mean over occupied rows / max), and mean occ3 over occupied rows —
    the candidate-scan bound the kernels actually pay."""
    gy = settings.grid_h
    occ_cell = jnp.sum((gs.pos_x < SENTINEL_HALF).astype(jnp.int32),
                       axis=1)  # [Gy_total, Gxp]
    occ_cell = occ_cell.reshape(n_worlds, gy, -1)
    n_parts = jnp.sum(occ_cell, axis=(1, 2))
    rowmax = jnp.max(occ_cell, axis=2)  # [W, Gy]
    occupied = rowmax > 0
    n_rows = jnp.sum(occupied.astype(jnp.int32), axis=1)
    lo = jnp.concatenate([rowmax[:, :1] * 0, rowmax[:, :-1]], axis=1)
    hi = jnp.concatenate([rowmax[:, 1:], rowmax[:, :1] * 0], axis=1)
    occ3 = jnp.maximum(jnp.maximum(lo, rowmax), hi)
    denom = jnp.maximum(n_rows, 1).astype(jnp.float32)
    mean_rowmax = (jnp.sum(jnp.where(occupied, rowmax, 0), axis=1)
                   / denom)
    mean_occ3 = (jnp.sum(jnp.where(occupied, occ3, 0), axis=1)
                 / denom)
    return dict(
        particles=[int(x) for x in n_parts],
        occupied_rows=[int(x) for x in n_rows],
        rowmax_mean=[float(x) for x in mean_rowmax],
        rowmax_max=[int(x) for x in jnp.max(rowmax, axis=1)],
        occ3_mean=[float(x) for x in mean_occ3],
    )


def world_state(gs: GridState, settings: SimSettings, w: int) -> GridState:
    """Slice world ``w`` out of a batched row stack."""
    gy = settings.grid_h
    sl = slice(w * gy, (w + 1) * gy)
    return GridState(
        pos_x=gs.pos_x[sl], pos_y=gs.pos_y[sl],
        vel_x=gs.vel_x[sl], vel_y=gs.vel_y[sl],
        occ_row=gs.occ_row[sl], tick=gs.tick, lost=gs.lost,
    )
