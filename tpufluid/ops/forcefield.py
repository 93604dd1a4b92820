"""Obstacle force field: SDF rasterization + on-device jump-flood distance field.

Replaces the reference's only host round-trip (SURVEY.md section 2.5): there,
obstacles are SDF-rasterized to an R8Uint mask on the GPU
(image_shader.wgsl:42-85), read back to the CPU, chamfer-distance-transformed
on a worker thread (src/main.rs:403-515), and re-uploaded as a push-out
vector field. The reference *shipped* a jump-flood WGSL kernel intended to
keep this on-device but never dispatched it (shaders/jump_flood.wgsl,
src/simulation.rs:423-427). This module is that finished design: everything
runs inside jit, so the sim loop never leaves the device.

Semantics of the output field (matching src/main.rs:495-511): for every
pixel, a vector in *pixel units* pointing to the nearest "outside" pixel
(mask 255); zero on outside pixels themselves. Applied by the integrator as
a position push-out plus normal-velocity damping (compute.wgsl:127-140).

One deliberate fix vs the reference: the mask here is rasterized in
sim-bounds space (uv * bounds - bounds/2), the same space the integrator
samples it in. The reference rasterizes through the 53x30 *camera*
projection but samples over the 53x53 *sim* bounds, silently warping
obstacle positions.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..params import SimSettings

CIRCLE = 0
RECT = 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Objects:
    """SoA obstacle set (cf. reference ``FluidObject``, src/renderer.rs:82-90,
    where radius/rotation/extents are bitcast into pad words — here they are
    plain fields).

    kind: i32[M] (0 circle, 1 rect); position: f32[M,2];
    radius: f32[M] (circles); extents: f32[M,2], rotation: f32[M] (rects).
    """

    kind: jax.Array
    position: jax.Array
    radius: jax.Array
    extents: jax.Array
    rotation: jax.Array

    @staticmethod
    def empty() -> "Objects":
        return Objects(
            kind=jnp.zeros((0,), jnp.int32),
            position=jnp.zeros((0, 2), jnp.float32),
            radius=jnp.zeros((0,), jnp.float32),
            extents=jnp.zeros((0, 2), jnp.float32),
            rotation=jnp.zeros((0,), jnp.float32),
        )

    @staticmethod
    def from_list(objs) -> "Objects":
        """objs: list of ("circle", pos, radius) / ("rect", pos, extents, rot)."""
        kinds, poss, radii, exts, rots = [], [], [], [], []
        for o in objs:
            if o[0] == "circle":
                kinds.append(CIRCLE); poss.append(o[1]); radii.append(o[2])
                exts.append((0.0, 0.0)); rots.append(0.0)
            elif o[0] == "rect":
                kinds.append(RECT); poss.append(o[1]); radii.append(0.0)
                exts.append(o[2]); rots.append(o[3] if len(o) > 3 else 0.0)
            else:
                raise ValueError(f"unknown object kind {o[0]!r}")
        return Objects(
            kind=jnp.asarray(kinds, jnp.int32),
            position=jnp.asarray(poss, jnp.float32),
            radius=jnp.asarray(radii, jnp.float32),
            extents=jnp.asarray(exts, jnp.float32),
            rotation=jnp.asarray(rots, jnp.float32),
        )


def point_in_objects(points, objects: Objects):
    """bool[...]: point inside ANY object (image_shader.wgsl:47-64).

    Circles: distance < radius. Rects: rotate into local frame, AABB test
    against half-extents inclusive (image_shader.wgsl:70-85).
    """
    if objects.kind.shape[0] == 0:
        return jnp.zeros(points.shape[:-1], bool)
    local = points[..., None, :] - objects.position  # [..., M, 2]
    dist = jnp.linalg.norm(local, axis=-1)
    in_circle = (objects.kind == CIRCLE) & (dist < objects.radius)

    c = jnp.cos(-objects.rotation)
    s = jnp.sin(-objects.rotation)
    rx = local[..., 0] * c - local[..., 1] * s
    ry = local[..., 0] * s + local[..., 1] * c
    half = objects.extents * 0.5
    in_rect = (
        (objects.kind == RECT)
        & (rx >= -half[..., 0]) & (rx <= half[..., 0])
        & (ry >= -half[..., 1]) & (ry <= half[..., 1])
    )
    return jnp.any(in_circle | in_rect, axis=-1)


def rasterize_outside_mask(objects: Objects, settings: SimSettings):
    """bool[H, W]: True where the pixel center is OUTSIDE every object
    (the reference's value-255 region, image_shader.wgsl:66)."""
    w, hgt = settings.texture_size
    bounds = jnp.asarray(settings.size, jnp.float32)
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w
    ys = (jnp.arange(hgt, dtype=jnp.float32) + 0.5) / hgt
    wx = (xs - 0.5) * bounds[0]
    wy = (ys - 0.5) * bounds[1]
    pts = jnp.stack(jnp.meshgrid(wx, wy, indexing="xy"), axis=-1)  # [H, W, 2]
    return ~point_in_objects(pts, objects)


def _jfa_pass(seeds, jump, coords):
    """One jump-flood pass: examine 8 neighbors at +/-jump, keep nearest seed.

    seeds: i32[H, W, 2] coordinates (x, y) of each pixel's current best seed,
    INVALID (-big) where none. coords: i32[H, W, 2] own pixel coords.
    """
    big = jnp.int32(2**30)

    def dist2(s):
        d = s - coords
        valid = s[..., 0] >= 0
        dd = jnp.sum(d * d, axis=-1)
        return jnp.where(valid, dd, big)

    best = seeds
    best_d = dist2(seeds)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            shifted = shift2d(seeds, dy * jump, dx * jump, fill=-1)
            d = dist2(shifted)
            take = d < best_d
            best = jnp.where(take[..., None], shifted, best)
            best_d = jnp.where(take, d, best_d)
    return best


def shift2d(arr, dy, dx, fill):
    """out[y, x] = arr[y+dy, x+dx] on a [H, W, ...] array; constant ``fill``
    outside the image (no wraparound)."""
    h, w = arr.shape[:2]
    pad = [(max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))]
    pad += [(0, 0)] * (arr.ndim - 2)
    padded = jnp.pad(arr, pad, constant_values=fill)
    y0, x0 = max(dy, 0), max(dx, 0)
    return padded[y0:y0 + h, x0:x0 + w]


def jump_flood_field(outside_mask):
    """f32[H, W, 2] push-out vectors in pixel units via JFA (+1 refinement).

    Seeds are the outside pixels (or the image border if nothing is outside
    — src/main.rs:425-438). Output[y, x] = nearest_seed_xy - (x, y); zero on
    seed pixels. JFA is exact for all but rare corner cases (<= 1 px error),
    strictly better than the reference's two-pass chamfer approximation.
    """
    hgt, w = outside_mask.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (hgt, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (hgt, w), 1)
    coords = jnp.stack([xs, ys], axis=-1)

    border = (xs == 0) | (xs == w - 1) | (ys == 0) | (ys == hgt - 1)
    has_outside = jnp.any(outside_mask)
    seed_mask = jnp.where(has_outside, outside_mask, border)

    invalid = jnp.full_like(coords, -1)
    seeds = jnp.where(seed_mask[..., None], coords, invalid)

    jump = max(hgt, w) // 2
    while jump >= 1:
        seeds = _jfa_pass(seeds, jump, coords)
        jump //= 2
    seeds = _jfa_pass(seeds, 1, coords)  # JFA+1 cleanup

    field = (seeds - coords).astype(jnp.float32)
    valid = seeds[..., 0] >= 0
    return jnp.where(valid[..., None], field, 0.0)


@functools.partial(jax.jit, static_argnames=("settings",))
def obstacle_force_field(objects: Objects, settings: SimSettings):
    """Full on-device pipeline: objects -> mask -> JFA -> push-out field.

    Drop-in producer for the ``forcefield`` argument of
    ``make_step(..., has_force_field=True)``.
    """
    outside = rasterize_outside_mask(objects, settings)
    return jump_flood_field(outside)
