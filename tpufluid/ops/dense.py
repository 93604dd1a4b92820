"""Dense cell-grid neighbor pass: the [N] engine without neighbor gathers.

The windowed [N, 144] neighbor gathers of ops.grid read every candidate
through an index. This module instead scatters particles ONCE into a dense
per-cell slot grid in **row layout** ``[Gy, K, Gx]`` (K = cell_capacity,
minor dim = grid x), and every neighbor access becomes a jnp.roll of the
whole grid -- contiguous copies -- followed by per-(offset, k') broadcasts
of [Gy, 1, Gx] against the [Gy, K, Gx] self slots: elementwise math that
XLA fuses, no gathers.

Wrap-around of rolls is safe by construction: the one-cell sentinel ring
(grid dims ceil(size/h)+2, src/simulation.rs:140) is never occupied because
predicted positions are clamped to the half-bounds box.

The physics is the same pair math as ops.pairs (kernels from ops.kernels);
iteration order matches the windowed mode (offsets row-major, within-cell
slots in sorted order) so results agree to reduction-tree roundoff.

Capacity overflow (cell occupancy > K): surplus particles keep full state
and keep moving, but drop out of neighbor sums for the step — deterministic
degradation, surfaced by utils.profiling.health_check.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..params import SimSettings, TickParams
from . import kernels
from .prng import position_seed, rand_unit_vector


class DenseGrid(NamedTuple):
    flat: jax.Array       # i32[N] slot of each sorted particle (=size -> dropped)
    px: jax.Array         # f32[Gy, K, Gx] predicted x
    py: jax.Array         # f32[Gy, K, Gx] predicted y
    vx: jax.Array         # f32[Gy, K, Gx]
    vy: jax.Array         # f32[Gy, K, Gx]
    valid: jax.Array      # bool[Gy, K, Gx]
    n_dropped: jax.Array  # i32 particles beyond cell capacity


def ranks(sorted_cells):
    """Rank of each sorted particle within its cell run (no searchsorted:
    an associative max-scan over run-start positions)."""
    n = sorted_cells.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate([
        jnp.ones((1,), bool), sorted_cells[1:] != sorted_cells[:-1]])
    run_start = lax.associative_scan(jnp.maximum, jnp.where(first, iota, 0))
    return iota - run_start


def build_grid(pred_s, vel_s, sorted_cells, settings: SimSettings,
               dims=None) -> DenseGrid:
    """``dims``: optional (grid_h, grid_w) override — used by the sharded
    step, whose local grids span only a slab's columns plus halo.

    The x dimension is padded to a multiple of 128 columns, the resident
    engine's layout (ops.resident._gxp). The pad columns are permanently
    empty; stencil rolls wrap through them harmlessly.
    """
    return build_grid_cols(
        pred_s[:, 0], pred_s[:, 1], vel_s[:, 0], vel_s[:, 1],
        sorted_cells, settings, dims=dims,
    )


def build_grid_cols(pxs, pys, vxs, vys, sorted_cells,
                    settings: SimSettings, dims=None) -> DenseGrid:
    """Column-form build: one scatter per field into the slot grid."""
    k = settings.cell_capacity
    gy, gx = dims if dims is not None else (settings.grid_h, settings.grid_w)
    gx_pad = -(-gx // 128) * 128
    rank = ranks(sorted_cells)
    keep = rank < k
    cy = sorted_cells // gx
    cx = sorted_cells % gx
    size = gy * k * gx_pad
    flat = jnp.where(keep, (cy * k + rank) * gx_pad + cx, size)

    shape = (gy, k, gx_pad)

    def scat(vals):
        return jnp.zeros((size,), jnp.float32).at[flat].set(
            vals, mode="drop").reshape(shape)

    return DenseGrid(
        flat=flat,
        px=scat(pxs), py=scat(pys), vx=scat(vxs), vy=scat(vys),
        valid=jnp.zeros((size,), bool).at[flat].set(
            True, mode="drop").reshape(shape),
        n_dropped=jnp.sum(~keep).astype(jnp.int32),
    )


_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _roll(a, dy, dx):
    # nb[y, :, x] = a[y+dy, :, x+dx]
    return jnp.roll(a, (-dy, -dx), axis=(0, 2))


def _slot(a, kp):
    """a[:, kp:kp+1, :] with a traced kp."""
    return lax.dynamic_slice_in_dim(a, kp, 1, axis=1)


def density_pass(grid: DenseGrid, mass, h):
    """rho[Gy, K, Gx]: sum of m*poly6 over the 3x3 stencil (self included,
    matching funcs.wgsl:157-203). The per-slot loop is a fori_loop so the
    program stays small at any cell_capacity."""
    k = grid.px.shape[1]
    # derive the loop carry from the input so it inherits any shard_map
    # varying-axis type (a plain zeros() carry breaks under shard_map scans)
    dens = grid.px * 0.0
    for dy, dx in _OFFSETS:
        nx = _roll(grid.px, dy, dx)
        ny = _roll(grid.py, dy, dx)
        nv = _roll(grid.valid, dy, dx)

        def body(kp, acc):
            ddx = _slot(nx, kp) - grid.px
            ddy = _slot(ny, kp) - grid.py
            r2 = ddx * ddx + ddy * ddy
            w = kernels.poly6(h, r2)
            return acc + jnp.where(_slot(nv, kp), mass * w, 0.0)

        dens = lax.fori_loop(0, k, body, dens)
    return dens


def force_pass(grid: DenseGrid, dens_g, params: TickParams, h, sqr_radius,
               spiky_norm, visc_norm, frame, surface_tension: bool = False,
               adaptive_subsampling: bool = False):
    """(fx, fy, gx_, gy_)[Gy, K, Gx]: pressure force (f) and viscosity
    force (g), matching compute.wgsl:160-299 pair math (tie-break contract
    as in ops.pairs).

    Variants (SURVEY.md 2.12 / compute.wgsl:303-498):
    * ``surface_tension``: color-field gradient + laplacian force, folded
      into (fx, fy); self-pair included, per pairs.surface_tension.
    * ``adaptive_subsampling``: pressure candidates strided by 1/5/13 as
      the querying particle's density crosses 150/200 — the dense slot
      index IS the rank in the cell run, so the stride is ``kp % inc == 0``
      (shaders/compute.wgsl:170-174,195).
    """
    k = grid.px.shape[1]
    p_self = kernels.pressure_eos(
        dens_g, params.pressure_constant, params.rest_density)
    seed_self = (
        position_seed(jnp.stack([grid.px, grid.py], axis=-1))
        + frame * jnp.uint32(69)
    )
    k_self = jax.lax.broadcasted_iota(jnp.int32, grid.px.shape, 1)

    # carries derive from inputs (shard_map varying-axis propagation)
    zero = grid.px * 0.0
    fx, fy, gx_, gy_ = zero, zero, zero, zero
    coinc_count = zero.astype(jnp.uint32)

    if adaptive_subsampling:
        inc = (
            jnp.uint32(1)
            + jnp.where(dens_g >= 150.0, jnp.uint32(4), jnp.uint32(0))
            + jnp.where(dens_g >= 200.0, jnp.uint32(8), jnp.uint32(0))
        )
    if surface_tension:
        # seed per compute.wgsl:406 (WGSL u32(f32) saturates negatives to 0)
        st_seed = (
            jnp.maximum(grid.px, 0.0).astype(jnp.int32).astype(jnp.uint32)
            * jnp.uint32(324) + frame * jnp.uint32(5632)
        )
        st_dir = rand_unit_vector(st_seed)  # one draw per particle
        cgx, cgy, clap = zero, zero, zero

    for dy, dx in _OFFSETS:
        nx = _roll(grid.px, dy, dx)
        ny = _roll(grid.py, dy, dx)
        nvx = _roll(grid.vx, dy, dx)
        nvy = _roll(grid.vy, dy, dx)
        nv = _roll(grid.valid, dy, dx)
        ndens = _roll(dens_g, dy, dx)
        np_nb = kernels.pressure_eos(
            ndens, params.pressure_constant, params.rest_density)
        is_center = (dy == 0 and dx == 0)
        before = (dy < 0) or (dy == 0 and dx < 0)

        def body(kp, carry, nx=nx, ny=ny, nvx=nvx, nvy=nvy, nv=nv,
                 ndens=ndens, np_nb=np_nb, is_center=is_center,
                 before=before):
            if surface_tension:
                fx, fy, gx_, gy_, coinc_count, cgx, cgy, clap = carry
            else:
                fx, fy, gx_, gy_, coinc_count = carry
            ddx = _slot(nx, kp) - grid.px
            ddy = _slot(ny, kp) - grid.py
            r2 = ddx * ddx + ddy * ddy
            dst = jnp.sqrt(r2)
            ok = _slot(nv, kp) & grid.valid
            if is_center:
                ok = ok & (k_self != kp)
            in_range = ok & (r2 <= sqr_radius)

            safe = jnp.where(dst == 0.0, 1.0, dst)
            dirx = ddx / safe
            diry = ddy / safe

            coincident = in_range & (dst == 0.0)
            eff_seed = (seed_self
                        + jnp.minimum(coinc_count, jnp.uint32(1))
                        * jnp.uint32(2654435761))
            if is_center:
                salt = jnp.where(kp < k_self, jnp.uint32(0x27220A95),
                                 jnp.uint32(0))
                eff_seed = eff_seed + salt
            elif before:
                eff_seed = eff_seed + jnp.uint32(0x27220A95)
            rdir = rand_unit_vector(eff_seed)
            dirx = jnp.where(coincident, rdir[..., 0], dirx)
            diry = jnp.where(coincident, rdir[..., 1], diry)
            coinc_count = coinc_count + coincident.astype(jnp.uint32)

            ndk = _slot(ndens, kp)
            shared_p = (p_self + _slot(np_nb, kp)) * 0.5
            kern_p = kernels.spiky_derivative(h, dst, spiky_norm)
            safe_rho = jnp.where(ndk == 0.0, 1.0, ndk)
            scale_p = kern_p * shared_p / safe_rho
            in_range_p = in_range
            if adaptive_subsampling:
                in_range_p = in_range & (
                    (kp.astype(jnp.uint32) % inc) == jnp.uint32(0))
            fx = fx + jnp.where(in_range_p, dirx * scale_p, 0.0)
            fy = fy + jnp.where(in_range_p, diry * scale_p, 0.0)

            kern_v = kernels.viscosity(h, dst, visc_norm)
            scale_v = kern_v / safe_rho
            gx_ = gx_ + jnp.where(
                in_range, (_slot(nvx, kp) - grid.vx) * scale_v, 0.0)
            gy_ = gy_ + jnp.where(
                in_range, (_slot(nvy, kp) - grid.vy) * scale_v, 0.0)

            if surface_tension:
                # self-pair INCLUDED (pairs.color_field_* contract)
                ok_st = _slot(nv, kp) & grid.valid & (r2 <= sqr_radius)
                co_st = ok_st & (dst == 0.0)
                sdx = jnp.where(co_st, st_dir[..., 0], dirx)
                sdy = jnp.where(co_st, st_dir[..., 1], diry)
                grad = kernels.poly6_gradient(
                    h, jnp.stack([sdx, sdy], axis=-1))
                m_rho = params.mass / safe_rho
                cgx = cgx + jnp.where(ok_st, m_rho * grad[..., 0], 0.0)
                cgy = cgy + jnp.where(ok_st, m_rho * grad[..., 1], 0.0)
                lap = kernels.poly6_laplacian(h, dst)
                clap = clap + jnp.where(ok_st, m_rho * lap, 0.0)
                return fx, fy, gx_, gy_, coinc_count, cgx, cgy, clap
            return fx, fy, gx_, gy_, coinc_count

        if surface_tension:
            fx, fy, gx_, gy_, coinc_count, cgx, cgy, clap = lax.fori_loop(
                0, k, body, (fx, fy, gx_, gy_, coinc_count, cgx, cgy, clap))
        else:
            fx, fy, gx_, gy_, coinc_count = lax.fori_loop(
                0, k, body, (fx, fy, gx_, gy_, coinc_count))

    if surface_tension:
        # pairs.surface_tension composition (compute.wgsl:303-315)
        n_len = jnp.sqrt(cgx * cgx + cgy * cgy)
        safe_len = jnp.where(n_len == 0.0, 1.0, n_len)
        k_st = (-clap) / (n_len + 1e-6)
        coef = params.surface_tension_coefficient
        apply_st = n_len > params.surface_tension_threshold
        fx = fx + jnp.where(apply_st, -coef * k_st * (cgx / safe_len), 0.0)
        fy = fy + jnp.where(apply_st, -coef * k_st * (cgy / safe_len), 0.0)

    mu = params.viscosity_coefficient
    return fx, fy, gx_ * mu, gy_ * mu


def dense_neighbor_forces(pred_s, vel_s, sorted_cells, settings: SimSettings,
                          params: TickParams, norms, frame,
                          dims=None, **variant_kw):
    """Full dense pipeline for sorted particle arrays.

    Returns (density[N], pressure_force[N,2], viscosity_force[N,2],
    n_dropped). Out-of-capacity particles get density floor and zero force.
    ``dims``/``sorted_cells`` may describe a local (sharded-slab) grid.
    """
    d, fpx, fpy, fvx, fvy, nd = dense_forces_cols(
        pred_s[:, 0], pred_s[:, 1], vel_s[:, 0], vel_s[:, 1], sorted_cells,
        settings, params, norms, frame, dims=dims,
        **variant_kw,
    )
    return (d, jnp.stack([fpx, fpy], -1), jnp.stack([fvx, fvy], -1), nd)


def dense_forces_cols(pxs, pys, vxs, vys, sorted_cells,
                      settings: SimSettings, params: TickParams, norms,
                      frame, dims=None,
                      surface_tension: bool = False,
                      adaptive_subsampling: bool = False):
    """Column-form dense pipeline (all 1D particle arrays).

    Returns (density, f_pressure_x, f_pressure_y, f_visc_x, f_visc_y,
    n_dropped), each [N]."""
    from ..params import EPSILON

    h = jnp.float32(settings.smoothing_radius)
    sqr_radius = jnp.float32(settings.sqr_radius)
    grid = build_grid_cols(pxs, pys, vxs, vys, sorted_cells, settings,
                           dims=dims)

    dens_g = density_pass(grid, params.mass, h)
    dens_g = jnp.maximum(dens_g, EPSILON)
    dens_g = jnp.maximum(dens_g, 0.1)

    fx, fy, gx_, gy_ = force_pass(
        grid, dens_g, params, h, sqr_radius,
        jnp.float32(norms.spiky_derivative),
        jnp.float32(norms.viscosity), frame,
        surface_tension=surface_tension,
        adaptive_subsampling=adaptive_subsampling)

    # ONE wide row gather for the readback
    stack = jnp.stack(
        [dens_g.reshape(-1), fx.reshape(-1), fy.reshape(-1),
         gx_.reshape(-1), gy_.reshape(-1)], axis=1)  # [size, 5]
    fill = jnp.asarray([[0.1, 0.0, 0.0, 0.0, 0.0]], jnp.float32)
    stack = jnp.concatenate([stack, fill], axis=0)
    out = stack[jnp.minimum(grid.flat, stack.shape[0] - 1)]  # [N, 5]
    return (out[:, 0], out[:, 1], out[:, 2], out[:, 3], out[:, 4],
            grid.n_dropped)
