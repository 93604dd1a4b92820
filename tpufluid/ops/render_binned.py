"""Pixel-aligned binned rendering of the fluid surface, without gathers.

The windowed renderer (ops.render) gathers 5x5-cell candidate lists per
pixel. Here the screen is
tiled into SxS-pixel bins sized so one bin exceeds the metaball influence
radius (2.5h, the reference's 5x5-cell walk, fluid_shader.wgsl:39-40);
particles are scattered once into [By, Bx, K] bins, and each pixel then
sees its 3x3 neighbor bins through jnp.roll — zero per-pixel gathers. The
image is processed as [By, S, Bx, S] so bin-level candidates broadcast
over the bin's pixels.

Shading math is identical to ops.render.render_metaball
(fluid_shader.wgsl:28-103); coverage differs only beyond 2.5h where
contributions are < exp(-12.5) (invisible). Bin capacity overflow drops the
youngest candidates deterministically — visual-only degradation.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax.numpy as jnp
from jax import lax

from ..params import SimSettings
from ..state import ParticleState
from .dense import ranks
from .render import Camera, _smoothstep


def _bin_particles(xy_world, values, camera: Camera, width, height,
                   bin_px, capacity):
    """Scatter particles into pixel-aligned bins (with a 1-bin margin).

    xy_world: f32[N,2]; values: dict name -> f32[N].
    Returns (bins dict name -> f32[By+2, Bx+2, K], valid f32[...],
    (bx, by) bin counts without margin).
    """
    cx, cy = camera.center
    vw, vh = camera.view_size
    # continuous pixel coords (row 0 = +y, ops.render.Camera convention)
    px = ((xy_world[:, 0] - cx) / vw + 0.5) * width
    py = (0.5 - (xy_world[:, 1] - cy) / vh) * height
    bx = -(-width // bin_px)   # ceil: the image is padded up to bins
    by = -(-height // bin_px)
    ix = jnp.floor(px / bin_px).astype(jnp.int32) + 1
    iy = jnp.floor(py / bin_px).astype(jnp.int32) + 1
    inside = (ix >= 0) & (ix < bx + 2) & (iy >= 0) & (iy < by + 2)
    nbx, nby = bx + 2, by + 2
    bid = jnp.where(inside, iy * nbx + ix, nby * nbx)

    sb, perm = lax.sort_key_val(
        bid, jnp.arange(bid.shape[0], dtype=jnp.int32), is_stable=True)
    rank = ranks(sb)
    keep = (rank < capacity) & (sb < nby * nbx)
    flat = jnp.where(keep, sb * capacity + rank, nby * nbx * capacity)

    size = nby * nbx * capacity
    out = {}
    for name, v in values.items():
        out[name] = jnp.zeros((size,), jnp.float32).at[flat].set(
            v[perm], mode="drop").reshape(nby, nbx, capacity)
    valid = jnp.zeros((size,), jnp.float32).at[flat].set(
        1.0, mode="drop").reshape(nby, nbx, capacity)
    return out, valid, (bx, by)


def _pixel_world(camera: Camera, width, height, bin_px, bx, by):
    """World coords of each pixel, shaped [By, S, Bx, S, 2] (padded image)."""
    w_pad, h_pad = bx * bin_px, by * bin_px
    cxc, cyc = camera.center
    vw, vh = camera.view_size
    xs = cxc + ((jnp.arange(w_pad, dtype=jnp.float32) + 0.5) / width - 0.5) * vw
    ys = cyc + (0.5 - (jnp.arange(h_pad, dtype=jnp.float32) + 0.5) / height) * vh
    wx = jnp.broadcast_to(xs[None, :], (h_pad, w_pad))
    wy = jnp.broadcast_to(ys[:, None], (h_pad, w_pad))
    shape = (by, bin_px, bx, bin_px)
    return wx.reshape(shape), wy.reshape(shape)


def metaball_fields(state: ParticleState, settings: SimSettings,
                    width, height, camera: Camera,
                    bin_px: int | None = None, capacity: int | None = None):
    """(density, velocity_factor) per pixel, f32[H, W] each."""
    h = settings.smoothing_radius
    vw, vh = camera.view_size
    if bin_px is None:
        r_pix = 2.5 * h * max(width / vw, height / vh)
        bin_px = max(4, int(math.ceil(r_pix)))
    if capacity is None:
        # expected particles per bin at reference rest spacing, x2 headroom
        area_world = (bin_px * vw / width) * (bin_px * vh / height)
        capacity = max(8, int(math.ceil(area_world / 0.1**2 * 2)))
    speed = jnp.linalg.norm(state.velocity, axis=-1)
    bins, valid, (bx, by) = _bin_particles(
        state.predicted, dict(x=state.predicted[:, 0],
                              y=state.predicted[:, 1], s=speed),
        camera, width, height, bin_px, capacity)
    wx, wy = _pixel_world(camera, width, height, bin_px, bx, by)

    inv_tau = 1.0 / (settings.sqr_radius * 0.5)
    dens = jnp.zeros(wx.shape, jnp.float32)
    velf = jnp.zeros(wx.shape, jnp.float32)
    # candidates processed UNROLL per fori iteration: the [H, W] carry
    # round-trips HBM once per iteration, which dominated the frame at
    # 1080p (~500 candidate passes x 16 MB); unrolling divides that
    UNROLL = 8
    cap_pad = -(-capacity // UNROLL) * UNROLL
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            # interior [By, Bx, K] view of the rolled margin grid
            sl = lambda a: a[1 + dy: 1 + dy + by, 1 + dx: 1 + dx + bx]
            nx, ny, ns, nv = (sl(bins["x"]), sl(bins["y"]), sl(bins["s"]),
                              sl(valid))

            def body(kb, carry):
                d, v = carry
                for u in range(UNROLL):
                    k = jnp.minimum(kb * UNROLL + u, capacity - 1)
                    cand_x = lax.dynamic_slice_in_dim(nx, k, 1, 2)[..., 0]
                    cand_y = lax.dynamic_slice_in_dim(ny, k, 1, 2)[..., 0]
                    cand_s = lax.dynamic_slice_in_dim(ns, k, 1, 2)[..., 0]
                    cand_v = lax.dynamic_slice_in_dim(nv, k, 1, 2)[..., 0]
                    live = (cand_v[:, None, :, None] > 0.0) & (
                        kb * UNROLL + u < capacity)
                    ddx = cand_x[:, None, :, None] - wx
                    ddy = cand_y[:, None, :, None] - wy
                    r2 = ddx * ddx + ddy * ddy
                    c = jnp.where(live, jnp.exp(-r2 * inv_tau), 0.0)
                    d = d + c
                    v = v + c * cand_s[:, None, :, None]
                return d, v

            dens, velf = lax.fori_loop(
                0, cap_pad // UNROLL, body, (dens, velf))

    h_pad, w_pad = by * bin_px, bx * bin_px
    dens = dens.reshape(h_pad, w_pad)[:height, :width]
    velf = velf.reshape(h_pad, w_pad)[:height, :width]
    return dens, velf


def render_particles_binned(
    state: ParticleState, settings: SimSettings,
    width: int = 960, height: int = 540, camera: Camera = Camera(),
    scale: float = 0.35, colors=None, capacity: int | None = None,
):
    """Point-sprite framebuffer f32[H, W, 4] — binned variant of
    ops.render.render_particles (nearest-center sprite wins per pixel)."""
    from .render import DEFAULT_SPRITE_COLORS
    colors = colors or DEFAULT_SPRITE_COLORS
    vw, vh = camera.view_size
    r_pix = 0.5 * scale * max(width / vw, height / vh)
    bin_px = max(4, int(math.ceil(r_pix)))
    if capacity is None:
        area_world = (bin_px * vw / width) * (bin_px * vh / height)
        capacity = max(8, int(math.ceil(area_world / 0.1**2 * 2)))

    speed = jnp.linalg.norm(state.velocity, axis=-1)
    step_v = speed * 0.05
    c = jnp.asarray(colors, jnp.float32)
    t0 = jnp.clip(step_v / 0.4, 0.0, 1.0)
    t1 = jnp.clip((step_v - 0.4) / 0.45, 0.0, 1.0)
    t2 = jnp.clip((step_v - 0.85) / 0.15, 0.0, 1.0)
    col = jnp.where(
        (step_v < 0.4)[:, None], c[0] + (c[1] - c[0]) * t0[:, None],
        jnp.where(
            (step_v < 0.85)[:, None], c[1] + (c[2] - c[1]) * t1[:, None],
            c[2] + (c[3] - c[2]) * t2[:, None],
        ),
    )
    bins, valid, (bx, by) = _bin_particles(
        state.position,
        dict(x=state.position[:, 0], y=state.position[:, 1],
             r=col[:, 0], g=col[:, 1], b=col[:, 2]),
        camera, width, height, bin_px, capacity)
    wx, wy = _pixel_world(camera, width, height, bin_px, bx, by)

    best_d = jnp.full(wx.shape, jnp.inf, jnp.float32)
    best_rgb = jnp.zeros(wx.shape + (3,), jnp.float32)
    inv_scale = 1.0 / float(scale)
    UNROLL = 8
    cap_pad = -(-capacity // UNROLL) * UNROLL
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            sl = lambda a: a[1 + dy: 1 + dy + by, 1 + dx: 1 + dx + bx]
            nx, ny, nv = sl(bins["x"]), sl(bins["y"]), sl(valid)
            nr, ng, nb = sl(bins["r"]), sl(bins["g"]), sl(bins["b"])

            def body(kb, carry):
                bd, brgb = carry
                for u in range(UNROLL):
                    k = jnp.minimum(kb * UNROLL + u, capacity - 1)
                    pick = lambda a: lax.dynamic_slice_in_dim(
                        a, k, 1, 2)[..., 0][:, None, :, None]
                    ddx = pick(nx) - wx
                    ddy = pick(ny) - wy
                    duv = jnp.sqrt(ddx * ddx + ddy * ddy) * inv_scale
                    ok = ((pick(nv) > 0.0) & (duv <= 0.5) & (duv < bd)
                          & (kb * UNROLL + u < capacity))
                    rgb = jnp.stack(
                        [pick(nr), pick(ng), pick(nb)], axis=-1
                    ) * (1.0 - duv)[..., None]
                    bd = jnp.where(ok, duv, bd)
                    brgb = jnp.where(ok[..., None], rgb, brgb)
                return bd, brgb

            best_d, best_rgb = lax.fori_loop(
                0, cap_pad // UNROLL, body, (best_d, best_rgb))

    h_pad, w_pad = by * bin_px, bx * bin_px
    rgb = best_rgb.reshape(h_pad, w_pad, 3)[:height, :width]
    alpha = jnp.ones(rgb.shape[:2] + (1,), jnp.float32)
    return jnp.concatenate([rgb, alpha], axis=-1)


def shade_metaball(density, vel_factor,
                   background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                   density_clamp_blue: bool = False):
    """fluid_shader.wgsl:28-103 colormap: per-pixel (density, velocity
    factor) fields -> rgba f32[H, W, 4] (blue body, white edge highlight,
    red tint by speed; optional density>50 solid-blue clamp from
    shaders/fluid_shader.wgsl:101-103)."""
    vel_factor = vel_factor * 0.01
    log_factor = jnp.float32(5.0)
    vel_factor = jnp.log1p(log_factor * vel_factor) / jnp.log(1.0 + log_factor)
    vel_factor = jnp.clip(vel_factor, 0.0, 1.0)

    interior = _smoothstep(0.5, 1.5, density)
    edge = _smoothstep(0.7, 1.0, density) - _smoothstep(1.0, 1.5, density)
    edge = edge * (1.0 + vel_factor * 2.0)

    slow = jnp.asarray([0.0, 0.5, 1.0], jnp.float32)
    fast = jnp.asarray([1.0, 0.0, 0.0], jnp.float32)
    base = (slow + (fast - slow) * vel_factor[..., None]) * interior[..., None]
    color = base + edge[..., None]
    alpha = jnp.clip(interior, 0.0, 1.0)
    bg = jnp.asarray(background, jnp.float32)
    rgb = jnp.clip(color, 0.0, 1.0)
    rgb = bg + (rgb - bg) * alpha[..., None]
    if density_clamp_blue:
        blue = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
        rgb = jnp.where((density > 50.0)[..., None], blue, rgb)
    return jnp.concatenate([rgb, jnp.ones_like(alpha[..., None])], axis=-1)


def render_metaball_binned(
    state: ParticleState, settings: SimSettings,
    width: int = 960, height: int = 540, camera: Camera = Camera(),
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    density_clamp_blue: bool = False,
    bin_px: int | None = None, capacity: int | None = None,
):
    """Fluid-surface framebuffer f32[H, W, 4] — same shading as
    ops.render.render_metaball, binned candidate search."""
    density, vel_factor = metaball_fields(
        state, settings, width, height, camera, bin_px, capacity)
    return shade_metaball(density, vel_factor, background,
                          density_clamp_blue)
