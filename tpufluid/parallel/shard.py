"""Multi-device scaling: spatial slab sharding with halo exchange.

The reference is strictly single-GPU; its scaling mechanism is the
spatial-hash sort (SURVEY.md section 5, "Long-context analog"). This module
splits the world over a 1D ``jax.sharding.Mesh`` axis of devices (on GPUs
the collectives go through NCCL over NVLink): the [N] engines use
vertical slabs of grid-cell columns; each step exchanges a two-column halo
of boundary particles with mesh neighbors (``lax.ppermute``), computes
the identical SPH physics (tpufluid.ops.pairs) on the local+halo set, and
migrates particles whose new position crossed a slab boundary.

Why a TWO-column halo: forces on my edge particles need the *densities* of
the neighbor's first column, and those densities need the neighbor's second
column — shipping two columns of (predicted, velocity) once per step keeps
everything else local (one comm round, no density exchange).

Shape discipline: per-device arrays are fixed capacity ``C`` with a validity
mask; halo and migration buffers are fixed ``H``/``M`` slots packed by a
stable sort. Overflow drops deterministically and is reported in the step
stats, never an error (mirrors the reference's trim-and-warn buffer policy,
src/buffer.rs:49-55).

Exactness contract: sharded physics matches single-chip up to f32
summation order when (a) each slab is >= 3 cell columns, (b) per-step
displacement <= one cell (h), and (c) no capacity overflows; violations
degrade gracefully (deterministically dropped neighbor contributions /
one-step-late migrations).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from ..params import EPSILON, SimSettings, TickParams
from ..state import ParticleState, init_state
from ..ops import grid as gridops
from ..ops import pairs
from ..ops import prng
from ..step import _integrate, predict_positions


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    settings: SimSettings
    n_devices: int
    capacity: int             # per-device particle slots
    halo_capacity: int        # per-side halo slots
    migration_capacity: int   # per-side migration slots per step
    col_bounds: Tuple[int, ...]  # D+1 cell-x ownership boundaries


def _round8(x: int) -> int:
    return ((x + 7) // 8) * 8


def build_shard_spec(
    settings: SimSettings,
    n_devices: int,
    capacity_factor: float = 1.35,
    halo_capacity: Optional[int] = None,
    migration_capacity: Optional[int] = None,
) -> ShardSpec:
    interior = settings.grid_w - 2
    if interior < 3 * n_devices:
        raise ValueError(
            f"grid too narrow: {interior} interior columns for "
            f"{n_devices} devices (need >= 3 per slab)"
        )
    col_bounds = tuple(
        1 + (d * interior) // n_devices for d in range(n_devices + 1)
    )
    # Data-aware capacity: the spawn lattice is a centered block
    # (src/simulation.rs:147-163), so slab ownership is imbalanced at t=0 —
    # size capacity from the actual initial distribution, not N/D.
    base = init_state(settings)
    cx0 = np.asarray(gridops.cell_xy(base.position, settings))[:, 0]
    counts0 = np.bincount(
        np.clip(np.searchsorted(np.asarray(col_bounds)[1:-1], cx0,
                                side="right"), 0, n_devices - 1),
        minlength=n_devices,
    )
    per_dev = max(int(counts0.max()),
                  -(-settings.particle_count // n_devices))
    cap = _round8(int(np.ceil(per_dev * capacity_factor)))
    if halo_capacity is None:
        # two columns at ~4x rest compression
        per_col = settings.particle_count / interior
        halo_capacity = _round8(max(128, int(per_col * 2 * 4)))
    if migration_capacity is None:
        migration_capacity = halo_capacity
    return ShardSpec(
        settings=settings, n_devices=n_devices, capacity=cap,
        halo_capacity=_round8(halo_capacity),
        migration_capacity=_round8(migration_capacity),
        col_bounds=col_bounds,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedState:
    """Global arrays, sharded on the leading axis over mesh axis 'x'.

    position/velocity: f32[D*C, 2]; valid: bool[D*C]; tick: u32 (replicated).
    """

    position: jax.Array
    velocity: jax.Array
    valid: jax.Array
    tick: jax.Array


def state_specs() -> ShardedState:
    return ShardedState(
        position=P("x"), velocity=P("x"), valid=P("x"), tick=P()
    )


def make_mesh(spec: ShardSpec, devices=None):
    devices = devices if devices is not None else jax.devices()[: spec.n_devices]
    return jax.make_mesh((spec.n_devices,), ("x",), devices=devices)


def init_sharded(spec: ShardSpec, mesh=None) -> ShardedState:
    """Distribute the reference spawn lattice (state.init_state) into slabs
    by cell column, padded to per-device capacity."""
    base = init_state(spec.settings)
    pos = np.asarray(base.position)
    vel = np.asarray(base.velocity)
    cx = np.asarray(gridops.cell_xy(base.position, spec.settings))[:, 0]
    bounds = np.asarray(spec.col_bounds)
    owner = np.clip(
        np.searchsorted(bounds[1:-1], cx, side="right"), 0, spec.n_devices - 1
    )

    c = spec.capacity
    d = spec.n_devices
    gpos = np.zeros((d * c, 2), np.float32)
    gvel = np.zeros((d * c, 2), np.float32)
    gvalid = np.zeros((d * c,), bool)
    dropped = 0
    for dev in range(d):
        sel = np.nonzero(owner == dev)[0]
        if len(sel) > c:
            dropped += len(sel) - c
            sel = sel[:c]
        gpos[dev * c: dev * c + len(sel)] = pos[sel]
        gvel[dev * c: dev * c + len(sel)] = vel[sel]
        gvalid[dev * c: dev * c + len(sel)] = True
    if dropped:
        raise ValueError(
            f"init overflow: {dropped} particles exceed capacity "
            f"{c}; raise capacity_factor"
        )

    mesh = mesh or make_mesh(spec)
    sharding = jax.NamedSharding(mesh, P("x"))
    rep = jax.NamedSharding(mesh, P())
    return ShardedState(
        position=jax.device_put(jnp.asarray(gpos), sharding),
        velocity=jax.device_put(jnp.asarray(gvel), sharding),
        valid=jax.device_put(jnp.asarray(gvalid), sharding),
        tick=jax.device_put(jnp.zeros((), jnp.uint32), rep),
    )


def _pack(mask, arrays, cap):
    """Pack masked rows (in order) into fixed ``cap`` slots.

    Returns (packed_arrays, valid[cap], n_dropped). Deterministic: the first
    ``cap`` selected rows (by index) survive.
    """
    n = mask.shape[0]
    key = jnp.where(mask, 0, 1).astype(jnp.int32)
    _, perm = lax.sort_key_val(key, jnp.arange(n, dtype=jnp.int32),
                               is_stable=True)
    sel = perm[:cap]
    if cap > n:  # buffer larger than the source array: pad with slot 0
        sel = jnp.pad(sel, (0, cap - n))
    count = jnp.sum(mask.astype(jnp.int32))
    valid = jnp.arange(cap, dtype=jnp.int32) < count
    packed = tuple(a[sel] for a in arrays)
    dropped = jnp.maximum(count - cap, 0)
    return packed, valid, dropped


def make_sharded_step(spec: ShardSpec, mesh=None, has_force_field: bool = False,
                      debug: bool = False, neighbor_mode: str = "grid"):
    """Build the jitted multi-chip step.

    Returns ``step(sharded_state, params[, forcefield]) -> (state, stats)``;
    stats: dict of i32[D] per-device counters (valid count, drops).
    ``neighbor_mode``: "grid" (windowed gathers) or "dense" (slab-local
    dense cell grid, see ops.dense).
    """
    if neighbor_mode not in ("grid", "dense"):
        raise ValueError(f"unknown neighbor_mode {neighbor_mode!r}")
    settings = spec.settings
    # slab-local grid width: widest slab + 2 halo columns each side
    w_loc = int(max(
        b - a for a, b in zip(spec.col_bounds[:-1], spec.col_bounds[1:])
    )) + 4
    mesh = mesh or make_mesh(spec)
    d_count = spec.n_devices
    c = spec.capacity
    hcap = spec.halo_capacity
    mcap = spec.migration_capacity
    g = settings.num_cells
    grid_w = settings.grid_w
    norms = settings.kernel_norms()
    h = jnp.float32(settings.smoothing_radius)
    sqr_radius = jnp.float32(settings.sqr_radius)
    bounds_arr = jnp.asarray(spec.col_bounds, jnp.int32)
    inner_bounds = jnp.asarray(spec.col_bounds[1:-1], jnp.int32)

    right_perm = [(i, i + 1) for i in range(d_count - 1)]
    left_perm = [(i, i - 1) for i in range(1, d_count)]

    def send_right(tree):
        if d_count == 1:
            return jax.tree.map(jnp.zeros_like, tree)
        return jax.tree.map(
            lambda x: lax.ppermute(x, "x", right_perm), tree
        )

    def send_left(tree):
        if d_count == 1:
            return jax.tree.map(jnp.zeros_like, tree)
        return jax.tree.map(
            lambda x: lax.ppermute(x, "x", left_perm), tree
        )

    def local_step(state: ShardedState, params: TickParams, forcefield):
        pos, vel, valid = state.position, state.velocity, state.valid
        frame = state.tick + jnp.uint32(1)
        dev = lax.axis_index("x")
        lo = bounds_arr[dev]
        hi = bounds_arr[dev + 1]

        # ---- predict + cells (sentinel g for invalid slots)
        pred = predict_positions(pos, vel, params.delta, settings)
        cells = gridops.cell_id(pred, settings)
        cells = jnp.where(valid, cells, g)
        cx = cells % grid_w

        # ---- halo exchange: 2 boundary columns of (pred, vel) each way
        sr_mask = valid & (cx >= hi - 2)
        sl_mask = valid & (cx < lo + 2)
        (hr_pred, hr_vel), hr_valid, hr_drop = _pack(
            sr_mask, (pred, vel), hcap)
        (hl_pred, hl_vel), hl_valid, hl_drop = _pack(
            sl_mask, (pred, vel), hcap)
        # my right halo arrives at d+1 as its left-side halo, and vice versa
        rl_pred, rl_vel, rl_valid = send_right((hr_pred, hr_vel, hr_valid))
        rr_pred, rr_vel, rr_valid = send_left((hl_pred, hl_vel, hl_valid))

        # ---- combined set: local + received halos
        pred_c = jnp.concatenate([pred, rl_pred, rr_pred])
        vel_c = jnp.concatenate([vel, rl_vel, rr_vel])
        pos_c = jnp.concatenate([pos, jnp.zeros_like(rl_pred),
                                 jnp.zeros_like(rr_pred)])
        halo_valid = jnp.concatenate([valid, rl_valid, rr_valid])
        is_local = jnp.concatenate([
            valid, jnp.zeros((2 * hcap,), bool)])
        cells_c = jnp.where(
            halo_valid, gridops.cell_id(pred_c, settings), g)

        # ---- local binning over the combined set
        t = pred_c.shape[0]
        if neighbor_mode == "dense":
            # Local-grid dense path: remap global cells into a slab-local
            # column frame [0, w_loc) so every device's grid has the same
            # static shape; sorting by local ids preserves the global
            # (row-major) order. Roll wraparound joins the slab's left and
            # right halo columns, which are >= 3 cells apart in world space
            # — the radius cutoff rejects those pairs.
            cy_c = cells_c // grid_w
            lcx = (cells_c % grid_w) - (lo - 2)
            ok_loc = halo_valid & (lcx >= 0) & (lcx < w_loc) & (cells_c < g)
            g_loc = settings.grid_h * w_loc
            local_cells = jnp.where(ok_loc, cy_c * w_loc + lcx, g_loc)
            sorted_cells, perm = lax.sort_key_val(
                local_cells, jnp.arange(t, dtype=jnp.int32), is_stable=True)
            pred_s = pred_c[perm]
            vel_s = vel_c[perm]
            pos_s = pos_c[perm]
            local_s = is_local[perm]
            from ..ops import dense as denseops
            dens, f_p, f_v, _ = denseops.dense_neighbor_forces(
                pred_s, vel_s, sorted_cells, settings, params, norms, frame,
                dims=(settings.grid_h, w_loc),
            )
            new_pos, new_vel = _integrate(
                pos_s, vel_s, pred_s, dens, f_p + f_v, params, settings,
                forcefield if has_force_field else None,
            )
            return _migrate_and_merge(
                new_pos, new_vel, local_s, dev, frame,
                hr_drop + hl_drop, debug_extra=dict(
                    dbg_pred=pred_s, dbg_dens=dens, dbg_local=local_s,
                    dbg_cells=sorted_cells, dbg_fp=f_p, dbg_fv=f_v,
                ) if debug else None,
            )

        sorted_cells, perm = lax.sort_key_val(
            cells_c, jnp.arange(t, dtype=jnp.int32), is_stable=True)
        cell_start = jnp.searchsorted(
            sorted_cells, jnp.arange(g + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        pred_s = pred_c[perm]
        vel_s = vel_c[perm]
        pos_s = pos_c[perm]
        local_s = is_local[perm]

        win = gridops.point_windows(
            jnp.minimum(sorted_cells, g - 1), cell_start, settings)
        nb_idx = win.idx.reshape(t, -1)
        nb_valid = win.valid.reshape(t, -1)
        nb_pred = pred_s[nb_idx]

        # ---- physics (identical pair math to the single-chip step)
        dens = pairs.density(pred_s, nb_pred, nb_valid, params.mass, h)
        dens = jnp.maximum(dens, EPSILON)
        dens = jnp.maximum(dens, 0.1)
        nb_dens = dens[nb_idx]
        nb_vel = vel_s[nb_idx]
        sorted_idx = jnp.arange(t, dtype=jnp.int32)
        rand_seed = prng.position_seed(pred_s) + frame * jnp.uint32(69)
        f_p = pairs.pressure_force(
            sorted_idx, pred_s, dens, nb_idx, nb_pred, nb_dens, nb_valid,
            params.pressure_constant, params.rest_density, h, sqr_radius,
            jnp.float32(norms.spiky_derivative), rand_seed,
        )
        f_v = pairs.viscosity_force(
            sorted_idx, pred_s, vel_s, nb_idx, nb_pred, nb_vel, nb_dens,
            nb_valid, params.viscosity_coefficient, h, sqr_radius,
            jnp.float32(norms.viscosity),
        )
        new_pos, new_vel = _integrate(
            pos_s, vel_s, pred_s, dens, f_p + f_v, params, settings,
            forcefield if has_force_field else None,
        )
        return _migrate_and_merge(
            new_pos, new_vel, local_s, dev, frame, hr_drop + hl_drop,
            debug_extra=dict(
                dbg_pred=pred_s, dbg_dens=dens, dbg_local=local_s,
                dbg_cells=sorted_cells, dbg_fp=f_p, dbg_fv=f_v,
            ) if debug else None,
        )

    def _migrate_and_merge(new_pos, new_vel, local_s, dev, frame, halo_drop,
                           debug_extra=None):
        # ---- migration: owner by new position's cell column
        ncx = gridops.cell_xy(new_pos, settings)[..., 0]
        dest = jnp.clip(
            jnp.searchsorted(inner_bounds, ncx, side="right"),
            0, d_count - 1,
        ).astype(jnp.int32)
        route = jnp.clip(dest - dev, -1, 1)
        keep = local_s & (route == 0)
        go_l = local_s & (route == -1)
        go_r = local_s & (route == 1)
        (ml_pos, ml_vel), ml_valid, ml_drop = _pack(
            go_l, (new_pos, new_vel), mcap)
        (mr_pos, mr_vel), mr_valid, mr_drop = _pack(
            go_r, (new_pos, new_vel), mcap)
        al_pos, al_vel, al_valid = send_right((mr_pos, mr_vel, mr_valid))
        ar_pos, ar_vel, ar_valid = send_left((ml_pos, ml_vel, ml_valid))

        # ---- merge: keeps first, then arrivals
        (k_pos, k_vel), k_valid, _ = _pack(keep, (new_pos, new_vel), c)
        n_keep = jnp.sum(keep.astype(jnp.int32))
        n_al = jnp.sum(al_valid.astype(jnp.int32))

        la_idx = n_keep + jnp.arange(mcap, dtype=jnp.int32)
        ra_idx = n_keep + n_al + jnp.arange(mcap, dtype=jnp.int32)
        la_ok = al_valid & (la_idx < c)
        ra_ok = ar_valid & (ra_idx < c)
        la_tgt = jnp.where(la_ok, la_idx, c)
        ra_tgt = jnp.where(ra_ok, ra_idx, c)
        arrival_drop = (jnp.sum(al_valid.astype(jnp.int32)) - jnp.sum(la_ok)
                        + jnp.sum(ar_valid.astype(jnp.int32)) - jnp.sum(ra_ok))

        out_pos = k_pos.at[la_tgt].set(al_pos, mode="drop")
        out_pos = out_pos.at[ra_tgt].set(ar_pos, mode="drop")
        out_vel = k_vel.at[la_tgt].set(al_vel, mode="drop")
        out_vel = out_vel.at[ra_tgt].set(ar_vel, mode="drop")
        out_valid = k_valid.at[la_tgt].set(True, mode="drop")
        out_valid = out_valid.at[ra_tgt].set(True, mode="drop")
        out_pos = jnp.where(out_valid[:, None], out_pos, 0.0)
        out_vel = jnp.where(out_valid[:, None], out_vel, 0.0)

        stats = dict(
            n_valid=jnp.sum(out_valid.astype(jnp.int32))[None],
            halo_dropped=halo_drop[None],
            migration_dropped=(ml_drop + mr_drop + arrival_drop)[None],
        )
        if debug_extra is not None:
            stats.update({k: v[None] for k, v in debug_extra.items()})
        new_state = ShardedState(
            position=out_pos, velocity=out_vel, valid=out_valid, tick=frame)
        return new_state, stats

    specs_state = state_specs()
    specs_params = jax.tree.map(lambda _: P(), TickParams.default())
    stats_spec = dict(n_valid=P("x"), halo_dropped=P("x"),
                      migration_dropped=P("x"))
    if debug:
        stats_spec.update(
            dbg_pred=P("x"), dbg_dens=P("x"), dbg_local=P("x"),
            dbg_cells=P("x"), dbg_fp=P("x"), dbg_fv=P("x"),
        )

    if has_force_field:
        fn = jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(specs_state, specs_params, P()),
            out_specs=(specs_state, stats_spec),
        )
        return jax.jit(fn)

    fn = jax.shard_map(
        lambda s, p: local_step(s, p, None), mesh=mesh,
        in_specs=(specs_state, specs_params),
        out_specs=(specs_state, stats_spec),
    )
    return jax.jit(fn)


def gather_state(sharded: ShardedState) -> ParticleState:
    """Pull to host and compact valid particles into a ParticleState
    (density/cell/predicted left zeroed — refreshed by the next step)."""
    pos = np.asarray(sharded.position)
    vel = np.asarray(sharded.velocity)
    valid = np.asarray(sharded.valid)
    pos, vel = pos[valid], vel[valid]
    n = len(pos)
    return ParticleState(
        position=jnp.asarray(pos),
        predicted=jnp.asarray(pos),
        velocity=jnp.asarray(vel),
        density=jnp.zeros((n,), jnp.float32),
        cell=jnp.zeros((n,), jnp.uint32),
        tick=sharded.tick,
    )


# =====================================================================
# Resident-grid sharding: the grid-resident engine (ops.resident) over
# row-band slabs.
# =====================================================================
#
# The resident state is the dense slot grid [Gy, K, Gxp] and every stage
# works row by row, so the natural shard axis is the GRID ROW:
# each device owns a contiguous band of rows (world-space horizontal
# slabs). Per step:
#
#   1. local rebin over the band padded with one empty row per side —
#      arrivals into the pad rows belong to the mesh neighbors;
#   2. one ppermute each way ships those boundary rows; a slot-append
#      merge folds them into the receiving band's edge rows;
#   3. far movers (> 1 cell/step) go through a psum-gated all_gather of
#      fixed-size packets — every device re-inserts the ones landing in
#      its band (zero cost when there are none);
#   4. one ppermute each way ships a TWO-row (pos, vel) halo; density and
#      the forces+integration run on the band+halo and the middle
#      rows are kept. Two rows because edge-row forces need neighbor
#      densities, which need the neighbor's second row — shipping state
#      once keeps density local (same reasoning as the column sharding
#      above).
#
# Everything rides lax.ppermute; per-step comm volume is
# O(rows * K * Gx), independent of band height.

from ..ops import resident as residentops
from ..ops import slot_physics
from ..ops.slot_physics import SENTINEL, SENTINEL_HALF


@dataclasses.dataclass(frozen=True)
class ResidentShardSpec:
    settings: SimSettings
    n_devices: int
    rows_per_dev: int
    gy_pad: int
    far_capacity: int


def build_resident_spec(settings: SimSettings, n_devices: int,
                        far_capacity: Optional[int] = None) -> ResidentShardSpec:
    settings = residentops.pad_capacity(settings)
    gy = settings.grid_h
    rows = -(-gy // n_devices)
    if rows < 4:
        raise ValueError(
            f"grid too flat: {gy} rows over {n_devices} devices gives "
            f"{rows} rows/device (need >= 4 for the 2-row halo)")
    if far_capacity is None:
        far_capacity = _round8(
            max(1024, settings.particle_count // (64 * n_devices)))
    return ResidentShardSpec(
        settings=settings, n_devices=n_devices, rows_per_dev=rows,
        gy_pad=rows * n_devices, far_capacity=_round8(far_capacity))


def make_resident_mesh(spec: ResidentShardSpec, devices=None):
    devices = (devices if devices is not None
               else jax.devices()[: spec.n_devices])
    return jax.make_mesh((spec.n_devices,), ("x",), devices=devices)


def resident_state_specs():
    return residentops.GridState(
        pos_x=P("x"), pos_y=P("x"), vel_x=P("x"), vel_y=P("x"),
        occ_row=P("x"), tick=P(), lost=P())


def init_sharded_resident(spec: ResidentShardSpec, mesh=None):
    """Build the reference spawn lattice and shard the resident grid by
    row bands (rows padded to a device multiple with empty sentinels)."""
    gs = residentops.init_grid_state(spec.settings)
    mesh = mesh or make_resident_mesh(spec)
    pad = spec.gy_pad - gs.pos_x.shape[0]

    def padrow(a, fill):
        if pad == 0:
            return a
        p = jnp.full((pad,) + a.shape[1:], fill, a.dtype)
        return jnp.concatenate([a, p], axis=0)

    shard = jax.NamedSharding(mesh, P("x"))
    rep = jax.NamedSharding(mesh, P())
    return residentops.GridState(
        pos_x=jax.device_put(padrow(gs.pos_x, SENTINEL), shard),
        pos_y=jax.device_put(padrow(gs.pos_y, SENTINEL), shard),
        vel_x=jax.device_put(padrow(gs.vel_x, 0.0), shard),
        vel_y=jax.device_put(padrow(gs.vel_y, 0.0), shard),
        occ_row=jax.device_put(padrow(gs.occ_row, 0), shard),
        tick=jax.device_put(gs.tick, rep),
        lost=jax.device_put(gs.lost, rep),
    )


def gather_resident(gs, spec: ResidentShardSpec):
    """(ParticleState, live_count) from a sharded resident grid (pad rows
    are empty, so the plain conversion applies). Arrays are pulled to host
    first — the conversion's global gathers don't shard."""
    gs_host = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), gs)
    return residentops.to_particles(gs_host, spec.settings)


def make_sharded_resident_step(spec: ResidentShardSpec, mesh=None,
                               x_boundary: str = "bounce",
                               has_force_field: bool = False,
                               surface_tension: bool = False,
                               adaptive_subsampling: bool = False):
    """Jitted multi-chip resident step:
    ``step(gs, params[, forcefield]) -> (gs, stats)``;
    stats["n_valid"]: i32[D] live particles per device.

    Carries the full variant surface of the single-chip resident engine
    (x-wrap, obstacle force fields, surface tension, adaptive
    subsampling) — the reference's one engine does everything at once
    (compute.wgsl + shaders/compute.wgsl), so the sharded path must too.
    """
    settings = spec.settings
    d_count = spec.n_devices
    rloc = spec.rows_per_dev
    k = settings.cell_capacity
    gxp = residentops._gxp(settings)
    grid_w = settings.grid_w
    gy_glob = settings.grid_h
    h_inv = 1.0 / settings.smoothing_radius
    fcap = spec.far_capacity
    mesh = mesh or make_resident_mesh(spec)
    density, forces_integrate = residentops.physics_stages(
        residentops.physics_impl())

    right_perm = [(i, i + 1) for i in range(d_count - 1)]
    left_perm = [(i, i - 1) for i in range(1, d_count)]

    def send_right(tree):
        if d_count == 1:
            return jax.tree.map(jnp.zeros_like, tree)
        return jax.tree.map(lambda x: lax.ppermute(x, "x", right_perm), tree)

    def send_left(tree):
        if d_count == 1:
            return jax.tree.map(jnp.zeros_like, tree)
        return jax.tree.map(lambda x: lax.ppermute(x, "x", left_perm), tree)

    def merge_row(a4, b4, bcnt):
        """Append packed boundary-row B behind row A, per cell.

        a4/b4: 4 x [K, Gxp] (pos_x, pos_y, vel_x, vel_y), slot-packed with
        sentinel empties; bcnt: i32[Gxp] valid entries per cell of B
        (ppermute zero-fill => bcnt 0 => no-op). Returns (merged4, occ,
        n_overflow)."""
        acnt = jnp.sum((a4[0] < SENTINEL_HALF).astype(jnp.int32), axis=0)
        kiota = jax.lax.broadcasted_iota(jnp.int32, (k, gxp), 0)
        bidx = jnp.clip(kiota - acnt[None, :], 0, k - 1)
        sel = (kiota >= acnt[None, :]) & (
            kiota - acnt[None, :] < bcnt[None, :])
        out = tuple(
            jnp.where(sel, jnp.take_along_axis(b, bidx, axis=0), a)
            for a, b in zip(a4, b4))
        occ = jnp.max(jnp.minimum(acnt + bcnt, k))
        over = jnp.sum(jnp.maximum(acnt + bcnt - k, 0))
        return out, occ, over

    def local_step(gs, params, forcefield):
        frame = gs.tick + jnp.uint32(1)
        dt = params.delta
        dev = lax.axis_index("x")
        row_off = dev * rloc

        # ---- 1. rebin over the band + 1 pad row per side
        def pad1(a, fill):
            p = jnp.full((1,) + a.shape[1:], fill, a.dtype)
            return jnp.concatenate([p, a, p], axis=0)

        px, py, vx, vy, occ2, far_n, over_n = slot_physics.rebin(
            pad1(gs.pos_x, SENTINEL), pad1(gs.pos_y, SENTINEL),
            pad1(gs.vel_x, 0.0), pad1(gs.vel_y, 0.0),
            dt, settings, row_offset=row_off - 1)
        n_over = jnp.sum(over_n)
        n_far_loc = jnp.sum(far_n)

        # ---- 2. ship boundary-row arrivals, merge into edge rows
        low4 = tuple(a[0] for a in (px, py, vx, vy))      # -> dev-1
        high4 = tuple(a[rloc + 1] for a in (px, py, vx, vy))  # -> dev+1
        low_cnt = jnp.sum((low4[0] < SENTINEL_HALF).astype(jnp.int32),
                          axis=0)
        high_cnt = jnp.sum((high4[0] < SENTINEL_HALF).astype(jnp.int32),
                           axis=0)
        fl = send_right((*high4, high_cnt))   # from dev-1, lands in my row 0
        fr = send_left((*low4, low_cnt))      # from dev+1, my row rloc-1
        band = [a[1:rloc + 1] for a in (px, py, vx, vy)]
        occ_band = occ2[1:rloc + 1]
        m0, occ0, over0 = merge_row(
            tuple(a[0] for a in band), fl[:4], fl[4])
        mT, occT, overT = merge_row(
            tuple(a[rloc - 1] for a in band), fr[:4], fr[4])
        band = [
            a.at[0].set(r0).at[rloc - 1].set(rT)
            for a, r0, rT in zip(band, m0, mT)]
        occ_band = occ_band.at[0].set(occ0).at[rloc - 1].set(occT)
        merge_over = over0 + overT

        # ---- 3. far movers: psum-gated all_gather of fixed packets
        total_far = lax.psum(n_far_loc, "x")

        def do_far(ops):
            bpx, bpy, bvx, bvy, occ_b = ops
            half = jnp.asarray(settings.size, jnp.float32) * 0.5
            prx = jnp.clip(gs.pos_x + gs.vel_x * dt, -half[0], half[0])
            pry = jnp.clip(gs.pos_y + gs.vel_y * dt, -half[1], half[1])
            ncx = jnp.clip(
                jnp.floor((prx + half[0]) * h_inv).astype(jnp.int32) + 1,
                1, grid_w - 2)
            ncy = jnp.clip(
                jnp.floor((pry + half[1]) * h_inv).astype(jnp.int32) + 1,
                1, gy_glob - 2)
            scx = jax.lax.broadcasted_iota(jnp.int32, gs.pos_x.shape, 2)
            scy = (jax.lax.broadcasted_iota(jnp.int32, gs.pos_x.shape, 0)
                   + row_off)
            far = (gs.pos_x < SENTINEL_HALF) & (
                (jnp.abs(ncy - scy) > 1) | (jnp.abs(ncx - scx) > 1))
            far_flat = far.reshape(-1)
            fields = jnp.stack(
                [gs.pos_x.reshape(-1), gs.pos_y.reshape(-1),
                 gs.vel_x.reshape(-1), gs.vel_y.reshape(-1)], axis=1)
            (pk,), pk_valid, pk_drop = _pack(far_flat, (fields,), fcap)
            packet = jnp.concatenate(
                [pk, pk_valid[:, None].astype(jnp.float32)], axis=1)
            allp = lax.all_gather(packet, "x")  # [D, fcap, 5]
            allp = allp.reshape(d_count * fcap, 5)
            flag = allp[:, 4] > 0.5
            gprx = jnp.clip(allp[:, 0] + allp[:, 2] * dt, -half[0], half[0])
            gpry = jnp.clip(allp[:, 1] + allp[:, 3] * dt, -half[1], half[1])
            gcx = jnp.clip(
                jnp.floor((gprx + half[0]) * h_inv).astype(jnp.int32) + 1,
                1, grid_w - 2)
            gcy = jnp.clip(
                jnp.floor((gpry + half[1]) * h_inv).astype(jnp.int32) + 1,
                1, gy_glob - 2)
            mine = flag & (gcy >= row_off) & (gcy < row_off + rloc)
            lcell = jnp.where(
                mine, (gcy - row_off) * grid_w + gcx, jnp.int32(2**30))
            m = d_count * fcap
            lcell_s, perm2 = lax.sort_key_val(
                lcell, jnp.arange(m, dtype=jnp.int32), is_stable=True)
            rows_s = allp[perm2]
            mine_s = mine[perm2]
            from ..ops.dense import ranks
            rank = ranks(lcell_s)
            occ_cell = jnp.sum(
                (bpx < SENTINEL_HALF).astype(jnp.int32), axis=1)
            cy2 = jnp.clip(lcell_s // grid_w, 0, rloc - 1)
            cx2 = jnp.clip(lcell_s % grid_w, 0, gxp - 1)
            base = occ_cell.reshape(-1)[cy2 * gxp + cx2]
            slot = base + rank
            fits = mine_s & (slot < k)
            flat = jnp.where(fits, (cy2 * k + slot) * gxp + cx2, bpx.size)
            bpx = bpx.reshape(-1).at[flat].set(
                rows_s[:, 0], mode="drop").reshape(bpx.shape)
            bpy = bpy.reshape(-1).at[flat].set(
                rows_s[:, 1], mode="drop").reshape(bpy.shape)
            bvx = bvx.reshape(-1).at[flat].set(
                rows_s[:, 2], mode="drop").reshape(bvx.shape)
            bvy = bvy.reshape(-1).at[flat].set(
                rows_s[:, 3], mode="drop").reshape(bvy.shape)
            dropped = (jnp.sum(mine_s.astype(jnp.int32))
                       - jnp.sum(fits.astype(jnp.int32)) + pk_drop)
            return (bpx, bpy, bvx, bvy, residentops.occ_row_of(bpx),
                    dropped)

        def no_far(ops):
            return (*ops, jnp.int32(0))

        bpx, bpy, bvx, bvy, occ_band, far_dropped = lax.cond(
            total_far > 0, do_far, no_far,
            (band[0], band[1], band[2], band[3], occ_band))

        # ---- 4. two-row halo exchange + physics on band+halo
        top2 = tuple(a[rloc - 2:rloc] for a in (bpx, bpy, bvx, bvy))
        bot2 = tuple(a[0:2] for a in (bpx, bpy, bvx, bvy))
        fb = send_right((*top2, occ_band[rloc - 2:rloc]))  # from dev-1
        fa = send_left((*bot2, occ_band[0:2]))             # from dev+1
        has_below = dev > 0
        has_above = dev < d_count - 1

        def sanitize(rows4, occ, has):
            pos_fill = jnp.full_like(rows4[0], SENTINEL)
            vel_fill = jnp.zeros_like(rows4[2])
            return (
                jnp.where(has, rows4[0], pos_fill),
                jnp.where(has, rows4[1], pos_fill),
                jnp.where(has, rows4[2], vel_fill),
                jnp.where(has, rows4[3], vel_fill),
                jnp.where(has, occ, jnp.zeros_like(occ)),
            )

        fb = sanitize(fb[:4], fb[4], has_below)
        fa = sanitize(fa[:4], fa[4], has_above)
        L = [jnp.concatenate([fb[i], b, fa[i]], axis=0)
             for i, b in enumerate((bpx, bpy, bvx, bvy))]
        occ_l = jnp.concatenate([fb[4], occ_band, fa[4]])

        pres, invr = density(
            L[0], L[1], L[2], L[3], occ_l, params.mass, dt,
            params.pressure_constant, params.rest_density, settings)
        ff_cells = None
        if has_force_field:
            ff_cells = residentops.forcefield_cells(
                forcefield, settings, gxp, row_start=row_off - 2,
                n_rows=rloc + 4)
        npx, npy, nvx, nvy = forces_integrate(
            L[0], L[1], L[2], L[3], pres, invr, occ_l, params, settings,
            frame, ff_cells=ff_cells, x_boundary=x_boundary,
            surface_tension=surface_tension,
            adaptive_subsampling=adaptive_subsampling)

        out = residentops.GridState(
            pos_x=npx[2:rloc + 2], pos_y=npy[2:rloc + 2],
            vel_x=nvx[2:rloc + 2], vel_y=nvy[2:rloc + 2],
            occ_row=occ_band, tick=frame,
            lost=gs.lost + lax.psum(
                n_over + merge_over + far_dropped, "x"),
        )
        n_valid = jnp.sum(
            (out.pos_x < SENTINEL_HALF).astype(jnp.int32))[None]
        return out, dict(n_valid=n_valid)

    specs_state = resident_state_specs()
    specs_params = jax.tree.map(lambda _: P(), TickParams.default())
    stats_spec = dict(n_valid=P("x"))

    if has_force_field:
        fn = jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(specs_state, specs_params, P()),
            out_specs=(specs_state, stats_spec),
            check_vma=False,  # pallas_call out_shapes carry no vma
        )
        return jax.jit(fn)

    fn = jax.shard_map(
        lambda s, p: local_step(s, p, None), mesh=mesh,
        in_specs=(specs_state, specs_params),
        out_specs=(specs_state, stats_spec),
        check_vma=False,  # pallas_call out_shapes carry no vma
    )
    return jax.jit(fn)
