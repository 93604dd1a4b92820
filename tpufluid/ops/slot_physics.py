"""Resident-engine stages on the slot grid, in plain ``jax.numpy``/``lax``.

The resident state is a dense slot grid ``[Gy, K, Gxp]`` per field
(K = cell capacity, minor axis = grid x); empty slots hold position
``SENTINEL``, which the range test ``r^2 <= h^2`` excludes on its own, so no
valid mask is carried. This module holds:

* the pair math and the integration (compute.wgsl:59-299 + 95-155), written
  once for operands that broadcast: the Triton kernels
  (ops.pallas.triton_resident) apply them to a ``[kb, bx]`` target tile and
  a ``[1, bx]`` candidate vector, the plain stages below to the whole
  ``[Gy, K, Gxp]`` grid and a ``[Gy, 1, Gxp]`` candidate slot;
* the plain stages ``rebin``, ``density`` and ``forces_integrate``: the
  engine on the CPU and the reference the GPU kernels are checked against.

Candidates are visited slot by slot, and within a slot over the 3x3 block
offsets in row-major order; within a cell, arrivals pack in (source row,
source column, slot) order. Results agree with the [N] engines to f32
reduction order.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..params import EPSILON, MAX_SPEED, SimSettings

PI = math.pi
# Empty grid slots hold this position; anything beyond SENTINEL_HALF is
# "not a particle". Real positions are bounded by the world half-extent.
SENTINEL = 1.0e9
SENTINEL_HALF = 5.0e8

# 3x3 block offsets (dy, dx), row-major: the candidate and packing order
OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def occ3_of(occ_row):
    """occ3[y] = max(occ_row[y-1], occ_row[y], occ_row[y+1]) with
    out-of-range rows empty."""
    occ = jnp.asarray(occ_row, jnp.int32).reshape(-1)
    lo = jnp.concatenate([occ[:1] * 0, occ[:-1]])
    hi = jnp.concatenate([occ[1:], occ[:1] * 0])
    return jnp.maximum(jnp.maximum(lo, occ), hi)


def predict(px, py, vx, vy, dt, half_x, half_y):
    """Clamped predicted positions (compute.wgsl:8-30), sentinel-preserving."""
    live = px < SENTINEL_HALF
    prx = jnp.clip(px + vx * dt, -half_x, half_x)
    pry = jnp.clip(py + vy * dt, -half_y, half_y)
    return jnp.where(live, prx, SENTINEL), jnp.where(live, pry, SENTINEL)


def cells_of(prx, pry, settings: SimSettings):
    """World cell (cx, cy) of clamped predicted positions, clamped to the
    interior like ops.grid.cell_xy (the sentinel ring stays empty even
    when size/h divides exactly in f32)."""
    h_inv = 1.0 / settings.smoothing_radius
    half_x = float(settings.size[0]) * 0.5
    half_y = float(settings.size[1]) * 0.5
    cx = jnp.clip(jnp.floor((prx + half_x) * h_inv).astype(jnp.int32) + 1,
                  1, settings.grid_w - 2)
    cy = jnp.clip(jnp.floor((pry + half_y) * h_inv).astype(jnp.int32) + 1,
                  1, settings.grid_h - 2)
    return cx, cy


# ------------------------------------------------------------ pair math

class Consts(NamedTuple):
    """Static kernel constants, baked in at trace time."""
    h: float
    h2: float
    poly6_norm: float
    spiky_norm: float
    visc_norm: float
    st_grad_norm: float
    st_lap_norm: float
    half_x: float
    half_y: float
    ff_sx: float  # obstacle field pixel -> world scale, (bounds*2)/texture
    ff_sy: float

    @staticmethod
    def of(settings: SimSettings) -> "Consts":
        h = float(settings.smoothing_radius)
        norms = settings.kernel_norms()
        return Consts(
            h=h, h2=h * h,
            poly6_norm=4.0 / (PI * h**8),
            spiky_norm=float(norms.spiky_derivative),
            visc_norm=float(norms.viscosity),
            st_grad_norm=-24.0 / (PI * h**8),
            st_lap_norm=8.0 / (PI * h**8),
            half_x=float(settings.size[0]) * 0.5,
            half_y=float(settings.size[1]) * 0.5,
            ff_sx=2.0 * float(settings.size[0]) / settings.texture_size[0],
            ff_sy=2.0 * float(settings.size[1]) / settings.texture_size[1],
        )


class Flags(NamedTuple):
    """Static variant flags (SURVEY.md 2.12)."""
    wrap_x: bool = False
    has_ff: bool = False
    surface_tension: bool = False
    adaptive: bool = False


def density_pair(acc, px0, py0, nx, ny, h2):
    """acc += (h^2 - r^2)^3 inside the radius (poly6 without its norm);
    max(diff, 0)^3 equals where(r2 > h2, 0, diff^3) exactly."""
    ddx = nx - px0
    ddy = ny - py0
    diff = jnp.maximum(h2 - (ddx * ddx + ddy * ddy), 0.0)
    return acc + diff * diff * diff


def density_finish(acc, live, mass, kp_c, rho0, poly6_norm):
    """(pressure, 1/rho) from the poly6 sum, with the reference's EPSILON
    and 0.1 floors (funcs.wgsl:202, compute.wgsl:70) and the linear EOS
    (funcs.wgsl:152-154). Empty slots get the floor density."""
    rho = mass * (jnp.float32(poly6_norm) * acc)
    rho = jnp.maximum(jnp.maximum(rho, EPSILON), 0.1)
    pres = jnp.where(live, kp_c * (rho - rho0), kp_c * (0.1 - rho0))
    invr = jnp.where(live, 1.0 / rho, 10.0)
    return pres, invr


def _xorshift32(x):
    x = x ^ (x << jnp.uint32(13))
    x = x ^ (x >> jnp.uint32(17))
    return x ^ (x << jnp.uint32(5))


def _u01(x):
    """uint32 -> [0, 1) float."""
    return x.astype(jnp.float32) / jnp.float32(4294967296.0)


def tie_dirs(prx, pry, frame):
    """Per-target base direction for coincident pairs (compute.wgsl:211-
    215). Coincident pairs (dst == 0) have bitwise equal predicted
    positions, so they share a cell and only the centre block draws; the
    four (pair-order salt, draw ordinal) variants are rotations and
    reflections of this one direction (see force_pair). The table only
    has to break exact ties deterministically with distinct directions."""
    bx = lax.bitcast_convert_type(prx, jnp.uint32)
    by = lax.bitcast_convert_type(pry, jnp.uint32)
    seed = (bx * jnp.uint32(0x9E3779B1)) ^ (by * jnp.uint32(0x85EBCA6B))
    seed = seed + frame * jnp.uint32(69)
    s1 = _xorshift32(seed)
    rx = _u01(s1)
    ry = _u01(_xorshift32(s1))
    inv = lax.rsqrt(jnp.maximum(rx * rx + ry * ry, 1e-30))
    return rx * inv, ry * inv


def st_dirs(prx, frame):
    """Surface-tension draw for coincident pairs, seeded per
    compute.wgsl:406 from the predicted x (WGSL u32(f32) saturates
    negatives to 0)."""
    st_i = jnp.maximum(prx, 0.0).astype(jnp.int32)
    seed = (lax.bitcast_convert_type(st_i, jnp.uint32) * jnp.uint32(324)
            + frame * jnp.uint32(5632))
    s1 = _xorshift32(seed)
    rx = _u01(s1)
    ry = _u01(_xorshift32(s1))
    n = jnp.sqrt(rx * rx + ry * ry)
    n = jnp.where(n == 0.0, 1.0, n)
    return rx / n, ry / n


class Target(NamedTuple):
    """Target slots (predicted position, velocity, own pressure and
    1/rho, tie table, slot index, surface-tension draw)."""
    px: jax.Array
    py: jax.Array
    vx: jax.Array
    vy: jax.Array
    pres: jax.Array
    invr: jax.Array
    d0x: jax.Array
    d0y: jax.Array
    slot: jax.Array
    stx: Optional[jax.Array] = None
    sty: Optional[jax.Array] = None


class Cand(NamedTuple):
    """One candidate slot of one block (predicted position, velocity,
    pressure, 1/rho)."""
    px: jax.Array
    py: jax.Array
    vx: jax.Array
    vy: jax.Array
    pres: jax.Array
    invr: jax.Array


class ForceAcc(NamedTuple):
    fx: jax.Array
    fy: jax.Array
    gx: jax.Array  # viscosity sum, scaled by mu * visc_norm at the end
    gy: jax.Array
    coinc: jax.Array  # u32 running count of coincident draws
    cgx: Optional[jax.Array] = None
    cgy: Optional[jax.Array] = None
    clap: Optional[jax.Array] = None


def zero_forces(like, surface_tension: bool) -> ForceAcc:
    z = jnp.zeros_like(like)
    st = (z, z, z) if surface_tension else (None, None, None)
    return ForceAcc(z, z, z, z, jnp.zeros(like.shape, jnp.uint32), *st)


def _adaptive_factor(kp, rho_self):
    """{0, 1} stride factor of adaptive subsampling
    (shaders/compute.wgsl:170-174,195): pressure candidates strided 1/5/13
    as the target's density crosses 150/200. The slot index is the rank
    in the cell run."""
    kp = jnp.asarray(kp, jnp.int32)  # >= 0, so rem is the modulus
    c5 = (lax.rem(kp, jnp.int32(5)) == 0).astype(jnp.float32)
    c13 = (lax.rem(kp, jnp.int32(13)) == 0).astype(jnp.float32)
    return jnp.where(rho_self >= 200.0, c13,
                     jnp.where(rho_self >= 150.0, c5, 1.0))


def force_pair(acc: ForceAcc, t: Target, c: Cand, kp, is_center: bool,
               mass, k: Consts, f: Flags) -> ForceAcc:
    """Pressure + viscosity (+ surface tension) of one candidate slot
    ``kp`` of one 3x3 block against the targets (compute.wgsl:160-299).

    Off-centre blocks take a lean form: min(dst - h, 0) IS the spiky term
    and is exactly 0 out of range, and the viscosity kernel
    -x^3/2 + x^2 + 1/(2x) - 1 (x = dst/h) has a double root at x = 1 and
    is <= 0 outside, so max(kv, 0) is the range gate. Sentinel candidates
    give dst ~ 1e9, and both clamp to 0."""
    fx, fy, gx, gy, coinc, cgx, cgy, clap = acc
    h, h2 = k.h, k.h2
    ddx = c.px - t.px
    ddy = c.py - t.py
    r2 = ddx * ddx + ddy * ddy
    # one rsqrt replaces sqrt + divide; at r2 == 0 dst is 0 and the
    # coincident path overwrites the direction
    inv_dst = lax.rsqrt(jnp.maximum(r2, 1e-35))
    dst = r2 * inv_dst
    neg_inv_2h3 = -1.0 / (2.0 * h * h2)
    inv_h2 = 1.0 / h2
    half_h = h / 2.0
    spiky_half = 0.5 * k.spiky_norm
    rho_self = 1.0 / t.invr if f.adaptive else None
    m_rho = mass * c.invr if f.surface_tension else None

    if not is_center:
        wp = (jnp.minimum(dst - h, 0.0) * spiky_half * (t.pres + c.pres)
              * c.invr)
        if f.adaptive:
            wp = wp * _adaptive_factor(kp, rho_self)
        s = wp * inv_dst
        fx = fx + ddx * s
        fy = fy + ddy * s
        if f.surface_tension:
            dirx = ddx * inv_dst
            diry = ddy * inv_dst
            cgx, cgy, clap = _st_pair(cgx, cgy, clap, dirx, diry, r2, dst,
                                      m_rho, r2 <= k.h2, k)
        kv = jnp.maximum(r2 * dst * neg_inv_2h3 + r2 * inv_h2
                         + inv_dst * half_h - 1.0, 0.0)
        wv = kv * c.invr
        return ForceAcc(fx, fy, gx + (c.vx - t.vx) * wv,
                        gy + (c.vy - t.vy) * wv, coinc, cgx, cgy, clap)

    in_range = (r2 <= k.h2) & (t.slot != kp)
    dirx = ddx * inv_dst
    diry = ddy * inv_dst
    # coincident-pair random direction, variants
    # (0,0)=(d0x,d0y) (0,1)=(-d0y,d0x) (1,0)=(-d0x,-d0y) (1,1)=(d0y,-d0x)
    coincident = in_range & (dst == 0.0)
    has_prior = coinc >= jnp.uint32(1)
    salted = kp < t.slot
    tx = jnp.where(salted, jnp.where(has_prior, t.d0y, -t.d0x),
                   jnp.where(has_prior, -t.d0y, t.d0x))
    ty = jnp.where(salted, jnp.where(has_prior, -t.d0x, -t.d0y),
                   jnp.where(has_prior, t.d0x, t.d0y))
    dirx = jnp.where(coincident, tx, dirx)
    diry = jnp.where(coincident, ty, diry)
    coinc = coinc + coincident.astype(jnp.uint32)

    in_range_p = in_range
    if f.adaptive:
        in_range_p = in_range & (_adaptive_factor(kp, rho_self) > 0.0)
    wp = jnp.where(in_range_p,
                   (dst - h) * spiky_half * (t.pres + c.pres) * c.invr, 0.0)
    fx = fx + dirx * wp
    fy = fy + diry * wp
    if f.surface_tension:
        # self pair INCLUDED (pairs.color_field_* contract)
        ok_st = r2 <= k.h2
        co_st = ok_st & (dst == 0.0)
        cgx, cgy, clap = _st_pair(
            cgx, cgy, clap, jnp.where(co_st, t.stx, dirx),
            jnp.where(co_st, t.sty, diry), r2, dst, m_rho, ok_st, k)
    kv = (r2 * dst * neg_inv_2h3 + r2 * inv_h2 + inv_dst * half_h - 1.0)
    kv = jnp.where(dst == 0.0, 1.0, kv)
    wv = jnp.where(in_range, kv * c.invr, 0.0)
    return ForceAcc(fx, fy, gx + (c.vx - t.vx) * wv,
                    gy + (c.vy - t.vy) * wv, coinc, cgx, cgy, clap)


def _st_pair(cgx, cgy, clap, sdx, sdy, r2, dst, m_rho, ok, k: Consts):
    """Colour-field gradient and laplacian of one pair (poly6 derivatives,
    pairs.color_field_*)."""
    rlen2 = sdx * sdx + sdy * sdy
    rlen = jnp.sqrt(rlen2)
    gdiff = k.h2 - rlen2
    gsc = jnp.where((rlen >= k.h) | (rlen == 0.0), 0.0,
                    jnp.float32(k.st_grad_norm) * gdiff * gdiff)
    lap = jnp.where(dst > k.h, 0.0,
                    jnp.float32(k.st_lap_norm) * (k.h2 - r2)
                    * (3.0 * k.h2 - 4.0 * r2))
    return (cgx + jnp.where(ok, m_rho * gsc * sdx, 0.0),
            cgy + jnp.where(ok, m_rho * gsc * sdy, 0.0),
            clap + jnp.where(ok, m_rho * lap, 0.0))


# Per-world scalar columns of the forces stage (TickParams fields).
FORCE_COLS = ("mu", "grav_x", "grav_y", "damping", "mouse_x", "mouse_y",
              "mouse_radius", "mouse_power", "mouse_state", "mass",
              "st_threshold", "st_coefficient")


def _stack_worlds(cols):
    """f32[W, len(cols)]; W is the leading dim of the batched columns
    (1 when every column is a scalar)."""
    n = max([1] + [c.shape[0] for c in cols if c.ndim])
    return jnp.stack([jnp.broadcast_to(c, (n,)) for c in cols], 1)


def force_scalars(params):
    """f32[W, len(FORCE_COLS)] per-world tunables."""
    mouse = jnp.asarray(params.mouse_pos, jnp.float32)
    grav = jnp.asarray(params.gravity, jnp.float32)
    f32 = lambda a: jnp.asarray(a).astype(jnp.float32)
    cols = [f32(params.viscosity_coefficient), grav[..., 0], grav[..., 1],
            f32(params.damping_factor), mouse[..., 0], mouse[..., 1],
            f32(params.mouse_force_radius), f32(params.mouse_force_power),
            f32(params.mouse_state), f32(params.mass),
            f32(params.surface_tension_threshold),
            f32(params.surface_tension_coefficient)]
    return _stack_worlds(cols)


def density_scalars(mass, pressure_constant, rest_density):
    """f32[W, 3] per-world (mass, k, rho0)."""
    return _stack_worlds([jnp.asarray(c, jnp.float32)
                          for c in (mass, pressure_constant, rest_density)])


def integrate(pos_x, pos_y, acc: ForceAcc, t: Target, sc, dt, ff,
              k: Consts, f: Flags):
    """Velocity + position update of move_particle (compute.wgsl:95-155):
    forces, gravity, mouse impulse, NaN reset, speed clamp, obstacle field
    (one pixel-space push-out vector per cell, ``ff = (ffx, ffy)``),
    boundary bounce or x-wrap. ``sc`` maps FORCE_COLS names to scalars or
    arrays that broadcast against the targets. Empty slots keep the
    sentinel."""
    mu = sc["mu"]
    visc = jnp.float32(k.visc_norm) * mu
    ax = acc.fx + acc.gx * visc
    ay = acc.fy + acc.gy * visc
    if f.surface_tension:
        # pairs.surface_tension composition (compute.wgsl:303-315)
        n_len = jnp.sqrt(acc.cgx * acc.cgx + acc.cgy * acc.cgy)
        safe_len = jnp.where(n_len == 0.0, 1.0, n_len)
        k_st = (-acc.clap) / (n_len + 1e-6)
        apply_st = n_len > sc["st_threshold"]
        coef = sc["st_coefficient"]
        ax = ax + jnp.where(apply_st, -coef * k_st * (acc.cgx / safe_len), 0.0)
        ay = ay + jnp.where(apply_st, -coef * k_st * (acc.cgy / safe_len), 0.0)
    vx = t.vx + ax * t.invr * dt + sc["grav_x"] * dt
    vy = t.vy + ay * t.invr * dt + sc["grav_y"] * dt

    # mouse impulse (compute.wgsl:99-108); dist == 0 under an active press
    # is 0/0 = NaN in the reference and the NaN reset then zeroes it
    diffx = sc["mouse_x"] - t.px
    diffy = sc["mouse_y"] - t.py
    dist = jnp.sqrt(diffx * diffx + diffy * diffy)
    msafe = jnp.where(dist == 0.0, 1.0, dist)
    state = sc["mouse_state"]
    radius = sc["mouse_radius"]
    iscale = sc["mouse_power"] * state * (dist / radius) / (msafe * msafe)
    iscale = jnp.where(dist == 0.0, jnp.float32(jnp.nan), iscale)
    apply_m = (state != 0.0) & (dist <= radius)
    vx = jnp.where(apply_m, vx + diffx * iscale, vx)
    vy = jnp.where(apply_m, vy + diffy * iscale, vy)

    # NaN reset (compute.wgsl:113-116) and speed clamp (:118-122)
    nan_any = (vx != vx) | (vy != vy)
    vx = jnp.where(nan_any, 0.0, vx)
    vy = jnp.where(nan_any, 0.0, vy)
    sp = jnp.sqrt(vx * vx + vy * vy)
    fast = sp > MAX_SPEED
    scl = MAX_SPEED / jnp.where(fast, sp, 1.0)
    vx = jnp.where(fast, vx * scl, vx)
    vy = jnp.where(fast, vy * scl, vy)

    px = pos_x + vx * dt
    py = pos_y + vy * dt
    damping = sc["damping"]
    if f.has_ff:
        # obstacle field at cell granularity (compute.wgsl:127-140 samples
        # per-particle texels): pixel-space normal, world-space push
        ffx, ffy = ff
        hit = (ffx != 0.0) | (ffy != 0.0)
        fn = jnp.sqrt(ffx * ffx + ffy * ffy)
        fsafe = jnp.where(fn == 0.0, 1.0, fn)
        nhx = ffx / fsafe
        nhy = ffy / fsafe
        px = jnp.where(hit, px + ffx * k.ff_sx, px)
        py = jnp.where(hit, py + ffy * k.ff_sy, py)
        vn = vx * nhx + vy * nhy
        vx = jnp.where(hit, vx - (1.0 - damping) * vn * nhx, vx)
        vy = jnp.where(hit, vy - (1.0 - damping) * vn * nhy, vy)

    # boundary clamp + bounce / x-wrap (compute.wgsl:143-153,
    # shaders/compute.wgsl:145-146)
    outx = jnp.abs(px) > k.half_x
    outy = jnp.abs(py) > k.half_y
    if f.wrap_x:
        px = jnp.where(outx, -k.half_x * jnp.sign(px), px)
    else:
        px = jnp.where(outx, k.half_x * jnp.sign(px), px)
        vx = jnp.where(outx, vx * -damping, vx)
    py = jnp.where(outy, k.half_y * jnp.sign(py), py)
    vy = jnp.where(outy, vy * -damping, vy)

    live = pos_x < SENTINEL_HALF
    return (jnp.where(live, px, SENTINEL), jnp.where(live, py, SENTINEL),
            jnp.where(live, vx, 0.0), jnp.where(live, vy, 0.0))


# --------------------------------------------------------- plain stages

def _shift(a, dy, dx, fill):
    """out[y, :, x] = a[y + dy, :, x + dx], ``fill`` outside the grid."""
    gy, _, gx = a.shape
    p = jnp.pad(a, ((1, 1), (0, 0), (1, 1)), constant_values=fill)
    return p[1 + dy:1 + dy + gy, :, 1 + dx:1 + dx + gx]


def _row_scalars(sc, wid, cols):
    """Per-world scalar table -> {name: scalar or f32[Gy, 1, 1]}."""
    if wid is None:
        return {c: sc[0, i] for i, c in enumerate(cols)}
    rows = sc[jnp.asarray(wid, jnp.int32)]
    return {c: rows[:, i, None, None] for i, c in enumerate(cols)}


def _slot(a, kp):
    return lax.dynamic_slice_in_dim(a, kp, 1, axis=1)


def density(pos_x, pos_y, vel_x, vel_y, occ_row, mass, dt,
            pressure_constant, rest_density, settings: SimSettings,
            wid=None):
    """(pres, inv_rho)[Gy, K, Gxp] from sentinel-encoded (pos, vel) grids
    (funcs.wgsl:157-203 + 152-154). ``wid``: i32[Gy] world of each row
    for batched world stacks; the scalars then carry a leading [W]."""
    k = Consts.of(settings)
    sc = _row_scalars(density_scalars(mass, pressure_constant, rest_density),
                      wid, ("mass", "kp", "rho0"))
    tpx, tpy = predict(pos_x, pos_y, vel_x, vel_y, dt, k.half_x, k.half_y)

    def body(kp, acc):
        nx, ny = predict(_slot(pos_x, kp), _slot(pos_y, kp),
                         _slot(vel_x, kp), _slot(vel_y, kp), dt,
                         k.half_x, k.half_y)
        for dy, dx in OFFSETS:
            acc = density_pair(acc, tpx, tpy, _shift(nx, dy, dx, SENTINEL),
                               _shift(ny, dy, dx, SENTINEL), k.h2)
        return acc

    acc = lax.fori_loop(0, jnp.max(occ_row), body, jnp.zeros_like(pos_x))
    return density_finish(acc, pos_x < SENTINEL_HALF, sc["mass"], sc["kp"],
                          sc["rho0"], k.poly6_norm)


def forces_integrate(pos_x, pos_y, vel_x, vel_y, pres, invr, occ_row,
                     params, settings: SimSettings, frame, ff_cells=None,
                     x_boundary: str = "bounce",
                     surface_tension: bool = False,
                     adaptive_subsampling: bool = False, wid=None):
    """3x3 pressure + viscosity (+ surface tension) forces fused with the
    full integration. Returns the new (pos_x, pos_y, vel_x, vel_y).

    ``ff_cells``: optional (ffx, ffy) f32[Gy, Gxp] pixel-space push-out
    vectors per cell (ops.resident.forcefield_cells). ``wid`` as in
    ``density``; params fields then carry a leading [W]."""
    k = Consts.of(settings)
    f = Flags(x_boundary == "wrap", ff_cells is not None, surface_tension,
              adaptive_subsampling)
    sc = _row_scalars(force_scalars(params), wid, FORCE_COLS)
    dt = jnp.asarray(params.delta, jnp.float32)
    frame = jnp.asarray(frame, jnp.uint32)
    t = target(pos_x, pos_y, vel_x, vel_y, pres, invr, dt, frame,
                jax.lax.broadcasted_iota(jnp.int32, pos_x.shape, 1), k, f)

    def body(kp, acc):
        nx, ny = predict(_slot(pos_x, kp), _slot(pos_y, kp),
                         _slot(vel_x, kp), _slot(vel_y, kp), dt,
                         k.half_x, k.half_y)
        fields = (nx, ny, _slot(vel_x, kp), _slot(vel_y, kp),
                  _slot(pres, kp), _slot(invr, kp))
        fills = (SENTINEL, SENTINEL, 0.0, 0.0, 0.0, 0.0)
        for dy, dx in OFFSETS:
            c = Cand(*(_shift(a, dy, dx, v) for a, v in zip(fields, fills)))
            acc = force_pair(acc, t, c, kp, dy == 0 and dx == 0,
                             sc["mass"], k, f)
        return acc

    acc = lax.fori_loop(0, jnp.max(occ_row), body,
                        zero_forces(pos_x, surface_tension))
    ff = None
    if ff_cells is not None:
        ff = (ff_cells[0][:, None, :], ff_cells[1][:, None, :])
    return integrate(pos_x, pos_y, acc, t, sc, dt, ff, k, f)


def target(pos_x, pos_y, vel_x, vel_y, pres, invr, dt, frame, slot,
            k: Consts, f: Flags) -> Target:
    """Target-side operands of force_pair for a block of slots."""
    tpx, tpy = predict(pos_x, pos_y, vel_x, vel_y, dt, k.half_x, k.half_y)
    d0x, d0y = tie_dirs(tpx, tpy, frame)
    stx = sty = None
    if f.surface_tension:
        stx, sty = st_dirs(tpx, frame)
    return Target(tpx, tpy, vel_x, vel_y, pres, invr, d0x, d0y, slot,
                  stx, sty)


def _shift2(a, dy, dx):
    """out[y, x] = a[y + dy, x + dx] over the leading two axes, 0 outside."""
    gy, gx = a.shape[:2]
    pad = ((1, 1), (1, 1)) + ((0, 0),) * (a.ndim - 2)
    return jnp.pad(a, pad)[1 + dy:1 + dy + gy, 1 + dx:1 + dx + gx]


def rebin(pos_x, pos_y, vel_x, vel_y, dt, settings: SimSettings,
          row_offset=0):
    """Move every slot to the cell of its next predicted position.

    Grids [Gy, K, Gxp] f32 (empty slots at position SENTINEL). Slots that
    move at most one cell pack into their new cell in (source row, source
    column, slot) order; each source slot's destination is computed with
    no sort, then one scatter with unique indices writes the new grid.
    ``row_offset``: world cell row of local row 0 (sharded bands), or
    i32[Gy] per row (batched world stacks: each row's own world frame).

    Returns (pos_x', pos_y', vel_x', vel_y', occ_row'[Gy], far_n[Gy],
    over_n[Gy]): far movers (> 1 cell) are left out and counted per source
    row in ``far_n`` (ops.resident re-inserts them); arrivals beyond the
    capacity are dropped and counted per target row in ``over_n``.
    """
    gy, kcap, gx = pos_x.shape
    live = pos_x < SENTINEL_HALF
    half_x = float(settings.size[0]) * 0.5
    half_y = float(settings.size[1]) * 0.5
    prx = jnp.clip(pos_x + vel_x * dt, -half_x, half_x)
    pry = jnp.clip(pos_y + vel_y * dt, -half_y, half_y)
    ncx, ncy = cells_of(prx, pry, settings)
    off = jnp.asarray(row_offset, jnp.int32)
    if off.ndim:
        off = off.reshape(gy, 1, 1)
    sy = lax.broadcasted_iota(jnp.int32, pos_x.shape, 0)
    sx = lax.broadcasted_iota(jnp.int32, pos_x.shape, 2)
    ty = ncy - off
    dy = ty - sy
    dx = ncx - sx
    near = live & (jnp.abs(dy) <= 1) & (jnp.abs(dx) <= 1)
    far_n = jnp.sum((live & ~near).astype(jnp.int32), axis=(1, 2))
    d = jnp.where(near, (dy + 1) * 3 + (dx + 1), 9)  # direction 0..8

    # rank among earlier slots of the same source cell and direction
    onehot = (d[..., None] == jnp.arange(9, dtype=jnp.int32)).astype(
        jnp.int32)  # [Gy, K, Gx, 9]
    incl = jnp.cumsum(onehot, axis=1)
    rank = jnp.sum(onehot * (incl - 1), axis=-1)
    cnt = incl[:, -1]  # [Gy, Gx, 9] slots leaving each cell per direction
    # arrivals into T from source T + OFFSETS[o] travel in direction 8 - o
    arr = jnp.stack([_shift2(cnt[..., 8 - o], oy, ox)
                     for o, (oy, ox) in enumerate(OFFSETS)], -1)
    prefix = jnp.cumsum(arr, axis=-1) - arr  # [Gy, Gx, 9]
    total = jnp.sum(arr, axis=-1)
    # a slot moving in direction d lands in T = S + OFFSETS[d], where it
    # comes from offset 8 - d; read that prefix back in the source frame
    base = jnp.stack([_shift2(prefix[..., 8 - dd], oy, ox)
                      for dd, (oy, ox) in enumerate(OFFSETS)], -1)
    dest = jnp.sum(onehot * base[:, None], axis=-1) + rank
    size = gy * kcap * gx
    ok = near & (dest < kcap) & (ty >= 0) & (ty < gy)
    # dropped slots get distinct out-of-range indices: all indices unique
    lin = jnp.arange(size, dtype=jnp.int32).reshape(pos_x.shape)
    flat = jnp.where(ok, (ty * kcap + dest) * gx + sx + dx, size + lin)

    def scat(vals, fill):
        return jnp.full((size,), fill, jnp.float32).at[flat.reshape(-1)].set(
            vals.reshape(-1), mode="drop", unique_indices=True
        ).reshape(pos_x.shape)

    occ_row = jnp.max(jnp.minimum(total, kcap), axis=1)
    over_n = jnp.sum(jnp.maximum(total - kcap, 0), axis=1)
    return (scat(pos_x, SENTINEL), scat(pos_y, SENTINEL),
            scat(vel_x, 0.0), scat(vel_y, 0.0),
            occ_row.astype(jnp.int32), far_n, over_n.astype(jnp.int32))
