"""Triton kernels (Pallas, ``backend="triton"``) for the resident engine's
physics on an NVIDIA GPU: density -> (pressure, 1/rho), and the
pressure + viscosity forces fused with the full integration.

Layout: one program per (grid row y, tile of ``bx`` columns, tile of
``kb`` slots). The program holds its ``[kb, bx]`` target tile in registers
and walks the candidate slots ``kp < occ3[y]`` (the largest occupancy of
rows y-1..y+1); for each slot it loads the nine 3x3-block candidate
vectors ``[bx]`` straight from device memory at
``(y + dy, kp, x0 + dx : x0 + dx + bx)`` and broadcasts them against the
tile. Each candidate is read once per target tile and never written back;
the plain stage (ops.slot_physics) instead streams the whole grid through
memory once per candidate slot. Blocks are independent: each loads its own
row occupancy and per-world scalars (``wid[y]`` picks the world of a row
in a batched stack), and a slot tile at or beyond ``occ_row[y]`` writes
the empty-slot defaults without a candidate loop.

Edges: candidate rows outside the grid read as sentinels; candidate
columns are clamped to the grid, which only ever substitutes the empty
ring or pad column for a target lane that is itself empty (ring column 0,
last pad column), whose result is discarded. ``Gxp`` is a multiple of 128
(ops.resident._gxp) and ``K`` a multiple of ``kb`` (ops.resident.
pad_capacity), so every target tile lies inside the arrays.

The pair math, the tie-break table and the integration are the functions
of ops.slot_physics, traced into the kernel; the kernels carry every
variant of the plain stages (surface tension, adaptive subsampling,
x-wrap, the cell-granular obstacle field, batched worlds).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import slot_physics as sp


def launch_for(k: int):
    """(bx, num_warps, num_stages) of the launch for cell capacity K.

    A [8, bx] f32 tile over 32 * num_warps threads keeps
    8 * bx / (32 * num_warps) values of each live array per thread; the
    forces kernel holds about twenty such arrays (targets, tie table,
    accumulators). Measured on an H100 80GB HBM3 at a 400 W power limit,
    density + forces on settled states (ms): the 1M scene (K = 8)
    0.390 at (64, 4, 1), 0.458 at (128, 4, 1), 0.483 at (64, 2, 1),
    0.52-0.57 at (32, 1, 1), (64, 1, 1), (128, 2, 1), (128, 8, 1); the 4k
    dam-break (K = 32, occupancy up to 26) 0.173 at (128, 8, 1), 0.199 at
    (64, 4, 1), 0.26-0.52 elsewhere. Two pipeline stages changed nothing
    measurable."""
    return (64, 4, 1) if k <= 8 else (128, 8, 1)


def slot_tile(k: int) -> int:
    """Target slots per program: min(K, 8); K is a power of two up to 8
    and a multiple of 8 above (ops.resident.pad_capacity)."""
    kb = min(k, 8)
    if k % kb or kb & (kb - 1):
        raise ValueError(f"cell_capacity {k} is not a power of two <= 8 or "
                         "a multiple of 8 (ops.resident.pad_capacity)")
    return kb


def _grid_and_params(shape):
    gy, k, gx = shape
    bx, warps, stages = launch_for(k)
    if gx % bx:
        raise ValueError(f"grid width {gx} is not a multiple of {bx}")
    kb = slot_tile(k)
    return (gy, gx // bx, k // kb), kb, bx, plgpu.CompilerParams(
        num_warps=warps, num_stages=stages)


def _cand_loader(gy, gx, x0, bx, y):
    """load(ref, kp, dy, dx) -> [1, bx] candidate vector of slot kp in the
    block (dy, dx) of row y, and whether that row is inside the grid."""
    cols = x0 + lax.broadcasted_iota(jnp.int32, (bx,), 0)

    def load(ref, kp, dy, dx):
        r = y + dy
        ci = jnp.clip(cols + dx, 0, gx - 1)
        return ref[jnp.clip(r, 0, gy - 1), kp, ci][None, :]

    def row_ok(dy):
        return (y + dy >= 0) & (y + dy < gy)

    return load, row_ok


def _density_kernel(sc_ref, dt_ref, wid_ref, occ_ref, occ3_ref,
                    px_ref, py_ref, vx_ref, vy_ref, pres_ref, invr_ref,
                    *, k: sp.Consts, kb: int, bx: int):
    gy, _, gx = px_ref.shape
    y = pl.program_id(0)
    x0 = pl.program_id(1) * bx
    k0 = pl.program_id(2) * kb
    w = wid_ref[y]
    dt = dt_ref[0]
    tile = (y, pl.ds(k0, kb), pl.ds(x0, bx))
    pos_x = px_ref[tile]
    tpx, tpy = sp.predict(pos_x, py_ref[tile], vx_ref[tile], vy_ref[tile],
                          dt, k.half_x, k.half_y)
    load, row_ok = _cand_loader(gy, gx, x0, bx, y)

    def body(kp, acc):
        for dy, dx in sp.OFFSETS:
            nx, ny = sp.predict(load(px_ref, kp, dy, dx),
                                load(py_ref, kp, dy, dx),
                                load(vx_ref, kp, dy, dx),
                                load(vy_ref, kp, dy, dx),
                                dt, k.half_x, k.half_y)
            ok = row_ok(dy)
            acc = sp.density_pair(acc, tpx, tpy,
                                  jnp.where(ok, nx, sp.SENTINEL),
                                  jnp.where(ok, ny, sp.SENTINEL), k.h2)
        return acc

    n = jnp.where(k0 < occ_ref[y], occ3_ref[y], 0)
    acc = lax.fori_loop(0, n, body, jnp.zeros((kb, bx), jnp.float32))
    pres, invr = sp.density_finish(
        acc, pos_x < sp.SENTINEL_HALF, sc_ref[w, 0], sc_ref[w, 1],
        sc_ref[w, 2], k.poly6_norm)
    pres_ref[tile] = pres
    invr_ref[tile] = invr


def density(pos_x, pos_y, vel_x, vel_y, occ_row, mass, dt,
            pressure_constant, rest_density, settings, wid=None,
            interpret: bool = False):
    """(pres, inv_rho)[Gy, K, Gxp]; arguments as ops.slot_physics.density.
    ``interpret`` runs the kernel in the Pallas interpreter (tests)."""
    gy = pos_x.shape[0]
    grid, kb, bx, params = _grid_and_params(pos_x.shape)
    occ_row = jnp.asarray(occ_row, jnp.int32).reshape(-1)
    wid = (jnp.zeros((gy,), jnp.int32) if wid is None
           else jnp.asarray(wid, jnp.int32))
    out = jax.ShapeDtypeStruct(pos_x.shape, jnp.float32)
    kernel = functools.partial(_density_kernel, k=sp.Consts.of(settings),
                               kb=kb, bx=bx)
    return pl.pallas_call(
        kernel, out_shape=(out, out), grid=grid, compiler_params=params,
        interpret=interpret, name="sph_density_triton",
    )(sp.density_scalars(mass, pressure_constant, rest_density),
      jnp.asarray(dt, jnp.float32).reshape(1), wid, occ_row,
      sp.occ3_of(occ_row), pos_x, pos_y, vel_x, vel_y)


def _forces_kernel(sc_ref, dt_ref, frame_ref, wid_ref, occ_ref, occ3_ref,
                   px_ref, py_ref, vx_ref, vy_ref, pres_ref, invr_ref,
                   *rest, k: sp.Consts, f: sp.Flags, kb: int, bx: int):
    if f.has_ff:
        ffx_ref, ffy_ref, npx_ref, npy_ref, nvx_ref, nvy_ref = rest
    else:
        npx_ref, npy_ref, nvx_ref, nvy_ref = rest
    gy, _, gx = px_ref.shape
    y = pl.program_id(0)
    x0 = pl.program_id(1) * bx
    k0 = pl.program_id(2) * kb
    w = wid_ref[y]
    dt = dt_ref[0]
    frame = frame_ref[0]
    sc = {c: sc_ref[w, i] for i, c in enumerate(sp.FORCE_COLS)}
    tile = (y, pl.ds(k0, kb), pl.ds(x0, bx))
    pos_x = px_ref[tile]
    slot = k0 + lax.broadcasted_iota(jnp.int32, (kb, bx), 0)
    t = sp.target(pos_x, py_ref[tile], vx_ref[tile], vy_ref[tile],
                   pres_ref[tile], invr_ref[tile], dt, frame, slot, k, f)
    load, row_ok = _cand_loader(gy, gx, x0, bx, y)

    def body(kp, acc):
        for dy, dx in sp.OFFSETS:
            cvx = load(vx_ref, kp, dy, dx)
            cvy = load(vy_ref, kp, dy, dx)
            nx, ny = sp.predict(load(px_ref, kp, dy, dx),
                                load(py_ref, kp, dy, dx), cvx, cvy,
                                dt, k.half_x, k.half_y)
            ok = row_ok(dy)
            c = sp.Cand(jnp.where(ok, nx, sp.SENTINEL),
                        jnp.where(ok, ny, sp.SENTINEL), cvx, cvy,
                        load(pres_ref, kp, dy, dx),
                        load(invr_ref, kp, dy, dx))
            acc = sp.force_pair(acc, t, c, kp, dy == 0 and dx == 0,
                                sc["mass"], k, f)
        return acc

    n = jnp.where(k0 < occ_ref[y], occ3_ref[y], 0)
    acc = lax.fori_loop(0, n, body,
                        sp.zero_forces(pos_x, f.surface_tension))
    ff = None
    if f.has_ff:
        cols = (y, pl.ds(x0, bx))
        ff = (ffx_ref[cols][None, :], ffy_ref[cols][None, :])
    new = sp.integrate(pos_x, py_ref[tile], acc, t, sc, dt, ff, k, f)
    for ref, val in zip((npx_ref, npy_ref, nvx_ref, nvy_ref), new):
        ref[tile] = val


def forces_integrate(pos_x, pos_y, vel_x, vel_y, pres, invr, occ_row,
                     params, settings, frame, ff_cells=None,
                     x_boundary: str = "bounce",
                     surface_tension: bool = False,
                     adaptive_subsampling: bool = False, wid=None,
                     interpret: bool = False):
    """New (pos_x, pos_y, vel_x, vel_y); arguments as
    ops.slot_physics.forces_integrate. ``interpret`` runs the kernel in
    the Pallas interpreter (tests)."""
    gy = pos_x.shape[0]
    grid, kb, bx, cparams = _grid_and_params(pos_x.shape)
    f = sp.Flags(x_boundary == "wrap", ff_cells is not None,
                 surface_tension, adaptive_subsampling)
    occ_row = jnp.asarray(occ_row, jnp.int32).reshape(-1)
    wid = (jnp.zeros((gy,), jnp.int32) if wid is None
           else jnp.asarray(wid, jnp.int32))
    args = [sp.force_scalars(params),
            jnp.asarray(params.delta, jnp.float32).reshape(1),
            jnp.asarray(frame, jnp.uint32).reshape(1), wid, occ_row,
            sp.occ3_of(occ_row), pos_x, pos_y, vel_x, vel_y, pres, invr]
    if ff_cells is not None:
        args += [jnp.asarray(ff_cells[0], jnp.float32),
                 jnp.asarray(ff_cells[1], jnp.float32)]
    out = jax.ShapeDtypeStruct(pos_x.shape, jnp.float32)
    kernel = functools.partial(_forces_kernel, k=sp.Consts.of(settings),
                               f=f, kb=kb, bx=bx)
    return pl.pallas_call(
        kernel, out_shape=(out,) * 4, grid=grid, compiler_params=cparams,
        interpret=interpret, name="sph_forces_integrate_triton",
    )(*args)
