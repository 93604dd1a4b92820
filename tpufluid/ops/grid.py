"""Spatial-hash grid: cell keys, sort-based binning, neighbor windows.

Replaces the reference's bitonic-sort + start-indices
pipeline (``sort.wgsl:27-51``, ``compute.wgsl:33-56``, host pass table
``src/simulation.rs:323-357``). Design choices (SURVEY.md section 7):

* The 153-dispatch bitonic sort of 32-byte AoS records becomes ONE XLA
  key/value sort of (u32 cell key, i32 index) pairs followed by a gather —
  O(n log n) on 8 bytes/record instead of O(n log^2 n) on 32.
* The racy ``compute_start_indices`` scatter (never-cleared buffer,
  compute.wgsl:45-56) becomes a clean ``searchsorted`` of all cell ids into
  the sorted key array: exact segment starts, no stale entries.
* The unbounded per-cell WGSL loops become fixed-shape windows: cells are
  row-major, so each 3x3 neighborhood is 3 contiguous runs of 3 cells in
  the sorted array; each run is read as a static ``3*cell_capacity`` slice
  plus a validity mask.

Cell math matches ``funcs.wgsl:206-218``: cell = floor((p + bounds/2)/h) + 1,
id = y*grid_w + x, with grid dims ceil(size/h)+2 (one sentinel ring, so the
+/-1 windows never need bounds checks; predicted positions are pre-clamped
to the half-bounds box by the predict pass).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..params import SimSettings


def cell_xy(point, settings: SimSettings):
    """Integer (x, y) cell coords of world-space points [... , 2] -> i32 [... , 2].

    Clamped to the interior [1, grid_dim-2]: when size/h divides exactly in
    f32 (e.g. h=0.5, size=8.0), a wall-clamped particle at +size/2 would
    otherwise land in floor(size/h)+1 == grid_dim-1 — the sentinel ring,
    whose emptiness the stencil kernels' row-clamp/roll-wrap tricks rely on.
    The clamp is also the physically right answer: the wall point belongs to
    the last interior cell's closed upper edge.
    """
    bounds = jnp.asarray(settings.size, jnp.float32)
    scaled = (point + bounds * 0.5) / jnp.float32(settings.smoothing_radius)
    xy = jnp.floor(scaled).astype(jnp.int32) + 1
    hi = jnp.asarray([settings.grid_w - 2, settings.grid_h - 2], jnp.int32)
    return jnp.clip(xy, 1, hi)


def cell_id(point, settings: SimSettings):
    """Row-major cell id of world-space points [... , 2] -> i32 [...]."""
    xy = cell_xy(point, settings)
    return xy[..., 1] * settings.grid_w + xy[..., 0]


class Binning(NamedTuple):
    """Result of binning: a permutation into cell-sorted order + segment table."""

    perm: jax.Array        # i32[N] gather indices: sorted[i] = orig[perm[i]]
    sorted_cells: jax.Array  # i32[N] cell id per sorted slot
    cell_start: jax.Array  # i32[G+1]; run of cell c is [cell_start[c], cell_start[c+1])


def bin_particles(cells, settings: SimSettings) -> Binning:
    """Sort particle indices by cell id and build the segment-start table."""
    n = cells.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    # Stable sort => deterministic within-cell order (the reference's bitonic
    # sort is merely *some* deterministic order; ours is insertion order).
    sorted_cells, perm = jax.lax.sort_key_val(
        cells.astype(jnp.int32), idx, is_stable=True
    )
    all_cells = jnp.arange(settings.num_cells + 1, dtype=jnp.int32)
    cell_start = jnp.searchsorted(sorted_cells, all_cells, side="left").astype(
        jnp.int32
    )
    return Binning(perm=perm, sorted_cells=sorted_cells, cell_start=cell_start)


class NeighborWindows(NamedTuple):
    """Fixed-shape neighbor candidates, in sorted-array order.

    idx:   i32[N, R, W] candidate slots into the *sorted* arrays, clamped.
    valid: bool[N, R, W] slot is a real particle of the neighborhood.
    R = number of cell rows in the stencil, W = 3*cell_capacity per row
    (or stencil width * capacity in general).
    """

    idx: jax.Array
    valid: jax.Array


def neighbor_windows(
    sorted_cells, cell_start, settings: SimSettings, radius_cells: int = 1,
    capacity: int | None = None,
) -> NeighborWindows:
    """Candidate windows for a (2r+1)x(2r+1) cell stencil around each particle.

    r=1 gives the force stencil (compute.wgsl:173-174), r=2 the renderer's
    5x5 (fluid_shader.wgsl:39-40), r=3 the density pass's 7x7
    (funcs.wgsl:161-162) — though poly6 support is one cell, so r=1 is
    mathematically identical for density (zero contributions beyond h).
    """
    return point_windows(
        sorted_cells, cell_start, settings, radius_cells, capacity
    )


def point_windows(
    point_cells, cell_start, settings: SimSettings, radius_cells: int = 1,
    capacity: int | None = None,
) -> NeighborWindows:
    """Neighbor windows for arbitrary query cell ids (i32[...]).

    Works for both particles (cells from the binning) and render pixels.
    Each of the (2r+1) stencil rows is one contiguous run of (2r+1) cells.
    """
    r = radius_cells
    cap = settings.cell_capacity if capacity is None else capacity
    width = (2 * r + 1) * cap
    w = settings.grid_w
    n_sorted = None  # clamp bound derived from cell_start's last entry

    # Row base cell: (y+dy)*W + (x-r)  == cell_id + dy*W - r
    dys = jnp.arange(-r, r + 1, dtype=jnp.int32)  # [R]
    base = point_cells[..., None] + dys * w - r  # [..., R]
    base = jnp.clip(base, 0, settings.num_cells - (2 * r + 1))
    start = cell_start[base]  # [..., R]
    end = cell_start[base + (2 * r + 1)]  # [..., R]

    offs = jnp.arange(width, dtype=jnp.int32)  # [W]
    idx = start[..., None] + offs  # [..., R, W]
    valid = idx < end[..., None]
    n_total = cell_start[-1]
    idx = jnp.minimum(idx, n_total - 1)
    idx = jnp.maximum(idx, 0)
    return NeighborWindows(idx=idx, valid=valid)


def max_cell_occupancy(cell_start) -> jax.Array:
    """Diagnostic: the largest per-cell particle count (compare cell_capacity)."""
    return jnp.max(cell_start[1:] - cell_start[:-1])
