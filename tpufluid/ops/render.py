"""Headless render-to-array kernels.

Replaces the reference's windowed render pipelines
(SURVEY.md sections 2.7 / 2.16): instead of winit surfaces and fragment
shaders, these produce RGBA framebuffers as device arrays inside jit.

* :func:`render_metaball` — the screen-space fluid surface pass
  (fluid_shader.wgsl:28-103): per-pixel Gaussian density + proximity-weighted
  speed over the neighbor grid, blue->red colormap with velocity-boosted
  edge highlight.
* :func:`render_particles` — the point-sprite particle renderer
  (particle_shader.wgsl:42-78, dead code in the reference but part of its
  capability surface): circular sprites with a 4-stop speed colormap and
  radial shading.

Both reuse the sim's cell binning for the per-pixel neighbor search; the
pixel loop is chunked with ``lax.map`` to bound the gather working set.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..params import SimSettings
from ..state import ParticleState
from . import grid as gridops


@dataclasses.dataclass(frozen=True)
class Camera:
    """Orthographic camera. The reference views 53x30 of the 53x53 world
    (src/renderer.rs:14,558-561). Row 0 of the output image is world +y
    (conventional orientation; the reference's clip-space convention
    displays world -y up, an artifact of its bottom/top swap)."""

    center: Tuple[float, float] = (0.0, 0.0)
    view_size: Tuple[float, float] = (53.0, 30.0)

    def pixel_world_coords(self, width: int, height: int):
        """f32[H, W, 2] world position of each pixel center."""
        cx, cy = self.center
        vw, vh = self.view_size
        xs = cx + ((jnp.arange(width, dtype=jnp.float32) + 0.5) / width - 0.5) * vw
        ys = cy + (0.5 - (jnp.arange(height, dtype=jnp.float32) + 0.5) / height) * vh
        return jnp.stack(jnp.meshgrid(xs, ys, indexing="xy"), axis=-1)


def _clamped_cell_id(points, settings: SimSettings):
    """Cell ids for arbitrary world points, clamped into the grid (pixels may
    lie outside the sim bounds; contributions fall off to exactly 0 anyway)."""
    xy = gridops.cell_xy(points, settings)
    x = jnp.clip(xy[..., 0], 0, settings.grid_w - 1)
    y = jnp.clip(xy[..., 1], 0, settings.grid_h - 1)
    return y * settings.grid_w + x


def _chunked_pixel_map(fn, pts, chunks: int):
    """Apply fn over flattened pixels in ``chunks`` sequential chunks."""
    h, w = pts.shape[:2]
    flat = pts.reshape(-1, 2)
    n = flat.shape[0]
    pad = (-n) % chunks
    flat = jnp.pad(flat, ((0, pad), (0, 0)))
    out = jax.lax.map(fn, flat.reshape(chunks, -1, 2))
    out = out.reshape(-1, out.shape[-1])[:n]
    return out.reshape(h, w, -1)


def render_metaball(
    state: ParticleState,
    settings: SimSettings,
    width: int = 960,
    height: int = 540,
    camera: Camera = Camera(),
    chunks: int = 8,
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    density_clamp_blue: bool = False,
):
    """Fluid surface framebuffer f32[H, W, 4] in [0, 1].

    Expects ``state`` as returned by the step (cell-sorted, predicted/cell
    populated) — the same buffers the reference's fragment shader reads
    (src/renderer.rs:457-458). ``density_clamp_blue`` reproduces the forked
    variant's solid-blue clamp above density 50
    (shaders/fluid_shader.wgsl:101-103, SURVEY.md section 2.12).
    """
    binning = gridops.bin_particles(state.cell.astype(jnp.int32), settings)
    pred = state.predicted[binning.perm]
    vel = state.velocity[binning.perm]
    speed = jnp.linalg.norm(vel, axis=-1)
    cell_start = binning.cell_start

    sqr_radius = jnp.float32(settings.sqr_radius)
    pts = camera.pixel_world_coords(width, height)

    def shade(chunk_pts):
        cells = _clamped_cell_id(chunk_pts, settings)
        win = gridops.point_windows(cells, cell_start, settings, radius_cells=2)
        idx = win.idx.reshape(chunk_pts.shape[0], -1)
        valid = win.valid.reshape(chunk_pts.shape[0], -1)
        nb = pred[idx]
        off = nb - chunk_pts[:, None, :]
        r2 = jnp.sum(off * off, axis=-1)
        # contrib = exp(-r^2 / (h^2/2)) (fluid_shader.wgsl:66)
        contrib = jnp.where(valid, jnp.exp(-r2 / (sqr_radius * 0.5)), 0.0)
        density = jnp.sum(contrib, axis=-1)
        vel_factor = jnp.sum(contrib * speed[idx], axis=-1)

        # colormap (fluid_shader.wgsl:79-101)
        vel_factor = vel_factor * 0.01
        log_factor = jnp.float32(5.0)
        vel_factor = jnp.log1p(log_factor * vel_factor) / jnp.log(1.0 + log_factor)
        vel_factor = jnp.clip(vel_factor, 0.0, 1.0)

        interior = _smoothstep(0.5, 1.5, density)
        edge = _smoothstep(0.7, 1.0, density) - _smoothstep(1.0, 1.5, density)
        edge = edge * (1.0 + vel_factor * 2.0)

        slow = jnp.asarray([0.0, 0.5, 1.0], jnp.float32)
        fast = jnp.asarray([1.0, 0.0, 0.0], jnp.float32)
        base = (slow + (fast - slow) * vel_factor[:, None]) * interior[:, None]
        color = base + edge[:, None]
        alpha = jnp.clip(interior, 0.0, 1.0)
        bg = jnp.asarray(background, jnp.float32)
        rgb = jnp.clip(color, 0.0, 1.0)
        rgb = bg + (rgb - bg) * alpha[:, None]
        if density_clamp_blue:
            blue = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
            rgb = jnp.where((density > 50.0)[:, None], blue, rgb)
        return jnp.concatenate([rgb, jnp.ones_like(alpha[:, None])], axis=-1)

    return _chunked_pixel_map(shade, pts, chunks)


DEFAULT_SPRITE_COLORS = (
    (0.05, 0.15, 0.9, 1.0),   # slow
    (0.1, 0.6, 1.0, 1.0),
    (1.0, 0.7, 0.1, 1.0),
    (1.0, 0.1, 0.05, 1.0),    # fast
)


def render_particles(
    state: ParticleState,
    settings: SimSettings,
    width: int = 960,
    height: int = 540,
    camera: Camera = Camera(),
    scale: float = 0.35,
    colors=DEFAULT_SPRITE_COLORS,
    chunks: int = 8,
):
    """Point-sprite framebuffer f32[H, W, 4].

    Sprite = circle of world diameter ``scale`` centered on each particle's
    position, radially shaded rgb*(1-dist) (particle_shader.wgsl:70-78),
    colored by the 4-stop speed ramp step=|v|*0.05 with knots at 0.4/0.85
    (particle_shader.wgsl:50-64). Where the reference alpha-blends sprites
    in instance order, we take the nearest-center sprite per pixel
    (equivalent for non-overlapping dots, deterministic under resort).
    """
    binning = gridops.bin_particles(state.cell.astype(jnp.int32), settings)
    pos = state.position[binning.perm]
    vel = state.velocity[binning.perm]
    cell_start = binning.cell_start

    step_v = jnp.linalg.norm(vel, axis=-1) * 0.05
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

    # sprite radius in cells decides the stencil size
    r_cells = max(1, int(jnp.ceil(scale * 0.5 / settings.smoothing_radius)))
    half = jnp.float32(scale * 0.5)
    pts = camera.pixel_world_coords(width, height)

    def shade(chunk_pts):
        cells = _clamped_cell_id(chunk_pts, settings)
        win = gridops.point_windows(
            cells, cell_start, settings, radius_cells=r_cells
        )
        idx = win.idx.reshape(chunk_pts.shape[0], -1)
        valid = win.valid.reshape(chunk_pts.shape[0], -1)
        nb = pos[idx]
        d = jnp.linalg.norm(nb - chunk_pts[:, None, :], axis=-1)
        # uv distance from sprite center: d/scale, cutoff at 0.5
        duv = d / jnp.float32(scale)
        covered = valid & (duv <= 0.5)
        d_pick = jnp.where(covered, duv, jnp.float32(jnp.inf))
        best = jnp.argmin(d_pick, axis=-1)
        rows = jnp.arange(idx.shape[0])
        hit = covered[rows, best]
        bd = duv[rows, best]
        bc = col[idx[rows, best]]
        rgb = bc[:, :3] * (1.0 - bd)[:, None]
        out = jnp.where(hit[:, None], rgb, 0.0)
        alpha = jnp.ones_like(out[:, :1])
        return jnp.concatenate([out, alpha], axis=-1)

    return _chunked_pixel_map(shade, pts, chunks)


def _smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def to_rgba8(frame):
    """f32[H, W, 4] in [0,1] -> u8[H, W, 4]."""
    return (jnp.clip(frame, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
