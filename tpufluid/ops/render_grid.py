"""Fluid-surface rendering straight off the resident slot grid.

Replaces the reference's fragment-shader surface pass
(fluid_shader.wgsl:28-103 + renderer.rs:159-234, RENDER_DIMS 960x540 at
renderer.rs:15): the Gaussian density / velocity fields are evaluated on
a world-aligned coarse lattice straight from the resident grid (no
``to_particles`` sort, no re-binning), then resampled to the camera
viewport with two matmuls (separable bilinear, no per-pixel gathers) and
shaded with the fluid_shader colormap (ops.render_binned.shade_metaball).

Exactness: identical colormap; the density field itself is bilinear-
interpolated from a lattice of ``supersample`` samples per cell per axis
(the Gaussian's sigma is supersample/sqrt(2) lattice units, so 2 resolves
it). For pixel-exact fields use ops.render / ops.render_binned.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
from jax import lax

from ..params import SimSettings
from ..state import ParticleState
from .render import Camera
from .render_binned import shade_metaball
from .slot_physics import SENTINEL

# cells of reach: the influence radius 2.5h (fluid_shader.wgsl:39-40)
# fits in +-3 cells
REACH = 3


def coarse_metaball_fields(pos_x, pos_y, speed, occ_row, settings,
                           supersample: int = 2):
    """(density, velocity_factor) f32[Hc, Wc] on the coarse world lattice.

    pos_x/pos_y/speed: resident slot grids [Gy, K, Gxp] (sentinel
    empties); occ_row: i32[Gy]. Hc = supersample * Gy,
    Wc = supersample * Gxp; lattice sample (i, j) sits at world
    ((j + 0.5) * h / supersample - half_x - h, likewise for i). One
    candidate slot at a time, each slot is expanded to the lattice
    (every cell repeated ``supersample`` times per axis) and shifted by
    whole cells over the 7x7 window of reach: elementwise work that XLA
    fuses, with no gathers. Sentinel slots contribute exp(-1e18/tau) = 0.
    """
    sup = int(supersample)
    gy, _, gxp = pos_x.shape
    h = float(settings.smoothing_radius)
    h_s = h / sup
    inv_tau = -1.0 / (float(settings.sqr_radius) * 0.5)
    wx = ((jnp.arange(sup * gxp, dtype=jnp.float32) + 0.5) * h_s
          - (float(settings.size[0]) * 0.5 + h))[None, :]
    wy = ((jnp.arange(sup * gy, dtype=jnp.float32) + 0.5) * h_s
          - (float(settings.size[1]) * 0.5 + h))[:, None]
    pad = REACH * sup

    def expand(a, fill):
        e = jnp.repeat(jnp.repeat(a[:, 0, :], sup, axis=0), sup, axis=1)
        return jnp.pad(e, pad, constant_values=fill)

    def body(kp, acc):
        dens, velf = acc
        sl = lambda a: lax.dynamic_slice_in_dim(a, kp, 1, axis=1)
        ex = expand(sl(pos_x), SENTINEL)
        ey = expand(sl(pos_y), SENTINEL)
        es = expand(sl(speed), 0.0)
        hc, wc = dens.shape
        for dy in range(-REACH, REACH + 1):
            for dx in range(-REACH, REACH + 1):
                win = lambda a: a[pad + dy * sup:pad + dy * sup + hc,
                                  pad + dx * sup:pad + dx * sup + wc]
                ddx = win(ex) - wx
                ddy = win(ey) - wy
                c = jnp.exp((ddx * ddx + ddy * ddy) * inv_tau)
                dens = dens + c
                velf = velf + c * win(es)
        return dens, velf

    z = jnp.zeros((sup * gy, sup * gxp), jnp.float32)
    return lax.fori_loop(0, jnp.max(occ_row), body, (z, z))


def _axis_weights(n_pix, pix_world, coarse_n, coarse_world_off, step):
    """[coarse_n, n_pix] bilinear interpolation matrix for one axis.

    pix_world: f32[n_pix] world coordinate per output pixel;
    coarse sample i sits at world ``(i + 0.5) * step - coarse_world_off``.
    Out-of-lattice pixels get all-zero weights (density-0 background).
    """
    u = (pix_world + coarse_world_off) / step - 0.5
    i0 = jnp.floor(u)
    w = (u - i0)[None, :]
    i0 = i0.astype(jnp.int32)[None, :]
    rows = jnp.arange(coarse_n, dtype=jnp.int32)[:, None]
    mat = (jnp.where(rows == i0, 1.0 - w, 0.0)
           + jnp.where(rows == i0 + 1, w, 0.0))
    inb = (u >= 0.0) & (u <= coarse_n - 1.0)
    return mat * inb[None, :]


def resample_fields(fields, settings, width, height, camera: Camera,
                    supersample: int):
    """Bilinear-resample [Hc, Wc] world-lattice fields to the [H, W]
    camera viewport via two matmuls (no gathers). The matmuls run at
    HIGHEST precision: a GPU otherwise multiplies float32 in TF32, whose
    ~3 decimal digits would quantise the density the colormap
    thresholds."""
    hc, wc = fields[0].shape
    h = settings.smoothing_radius
    step = h / supersample
    half = jnp.asarray(settings.size, jnp.float32) * 0.5
    cx, cy = camera.center
    vw, vh = camera.view_size
    # ops.render.Camera convention: row 0 is +y (top of the view)
    px = cx + ((jnp.arange(width, dtype=jnp.float32) + 0.5) / width
               - 0.5) * vw
    py = cy + (0.5 - (jnp.arange(height, dtype=jnp.float32) + 0.5)
               / height) * vh
    wx = _axis_weights(width, px, wc, half[0] + h, step)
    wy = _axis_weights(height, py, hc, half[1] + h, step)
    mm = lambda a, b: jnp.matmul(a, b, precision=lax.Precision.HIGHEST)
    return tuple(mm(mm(wy.T, f), wx) for f in fields)


def render_metaball_grid(
    gs, settings: SimSettings,
    width: int = 960, height: int = 540, camera: Camera = Camera(),
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    density_clamp_blue: bool = False, supersample: int = 2,
):
    """rgba f32[H, W, 4] fluid surface from a resident GridState.

    Positions are the grid's CURRENT positions (the per-pixel renderers
    use ``state.predicted`` like the reference's fragment shader; the
    difference is v*dt, sub-pixel at the default dt).
    """
    speed = jnp.sqrt(gs.vel_x * gs.vel_x + gs.vel_y * gs.vel_y)
    dens_c, velf_c = coarse_metaball_fields(
        gs.pos_x, gs.pos_y, speed, gs.occ_row, settings, supersample)
    dens, velf = resample_fields(
        (dens_c, velf_c), settings, width, height, camera, supersample)
    return shade_metaball(dens, velf, background, density_clamp_blue)


def render_metaball_state(
    state: ParticleState, settings: SimSettings,
    width: int = 960, height: int = 540, camera: Camera = Camera(),
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    density_clamp_blue: bool = False, supersample: int = 2,
):
    """Same pipeline for an [N]-engine ParticleState: one grid binning
    (scatter) replaces the per-frame sort + re-bin of the binned path."""
    from . import resident
    gs = resident.from_particles(state, settings)
    return render_metaball_grid(gs, settings, width, height, camera,
                                background, density_clamp_blue,
                                supersample)
