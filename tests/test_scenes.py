"""Benchmark scene presets: geometry invariants the bench relies on.

The tile-aligned scenes (models.scene_1m / scene_4m) promise (a) a
grid_w that lands exactly on the resident grid's 128-column padding
(zero pad columns, whole column tiles for the GPU kernels),
(b) a spawn lattice that fits the box (no boundary clamping at t=0), and
(c) initial cell occupancy within cell_capacity (zero loss at t=0).
SimSettings.spawn_columns must reproduce the reference lattice math
(src/simulation.rs:147-163) with only the column count overridden.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpufluid import models
from tpufluid.params import SimSettings
from tpufluid.state import init_state
from tpufluid.ops import resident


@pytest.mark.parametrize("scene_fn", [models.scene_1m, models.scene_4m,
                                      models.scene_64k, models.scene_256k])
def test_tile_aligned_scene_geometry(scene_fn):
    s = scene_fn().settings
    gxp = resident._gxp(s)
    assert s.grid_w % 128 == 0, (s.grid_w, "pad columns would waste work")
    assert gxp == s.grid_w

    st = init_state(s)
    pos = np.asarray(st.position)
    half = np.asarray(s.size) * 0.5
    assert np.abs(pos[:, 0]).max() < half[0]
    assert np.abs(pos[:, 1]).max() < half[1]


def test_scene_1m_spawn_binning_lossless():
    s = models.scene_1m().settings
    gs = resident.init_grid_state(s)
    assert int(gs.lost) == 0
    assert int(jnp.sum(resident.valid_mask(gs))) == s.particle_count
    assert int(jnp.max(gs.occ_row)) <= s.cell_capacity


def test_spawn_columns_reproduces_reference_lattice_math():
    """spawn_columns=floor(sqrt(n)) must give the identical lattice to the
    default sqrt(n) path only when sqrt(n) is an exact integer (the
    reference centers with the FLOAT row width)."""
    n = 4096  # sqrt = 64 exactly
    a = init_state(SimSettings(particle_count=n, size=(16.0, 16.0)))
    b = init_state(SimSettings(particle_count=n, size=(16.0, 16.0),
                               spawn_columns=64))
    assert np.array_equal(np.asarray(a.position), np.asarray(b.position))


def test_spawn_columns_rectangular_lattice():
    s = SimSettings(particle_count=1000, size=(16.0, 16.0),
                    spawn_columns=10)
    st = init_state(s)
    pos = np.asarray(st.position)
    # 10 columns x 100 rows at spacing 0.1, centered with the FLOAT
    # column count per the reference math: per_col = (n-1)/10 + 1 = 100.9
    assert np.isclose(pos[:, 0].max(), (10 - 1) / 2 * 0.1, atol=1e-5)
    assert np.isclose(pos[:, 1].max(), (99 - 100.9 / 2 + 0.5) * 0.1,
                      atol=1e-4)
    # row-major fill: consecutive particles step in x within a row
    assert np.isclose(pos[1, 0] - pos[0, 0], 0.1, atol=1e-6)
    assert pos[10, 1] > pos[0, 1] - 1e-6  # next row above or equal frame
