"""Golden-trajectory regression tests (SURVEY.md section 4, point 3).

A small dam-break is advanced a fixed number of steps and compared against
a stored snapshot. The snapshot is (re)generated on first run — commit the
file; subsequent runs must match within tight f32 tolerance (bitwise
stability across jax versions is not guaranteed, reduction-order stability
is what we test).

Regenerate intentionally with: REGEN_GOLDEN=1 python -m pytest tests/test_golden.py
"""

import os

import numpy as np
import pytest

from tpufluid import SimSettings, TickParams, init_state, make_step

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "dam_break_512_s30.npz")


def scenario():
    s = SimSettings(particle_count=512, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(8.0, 8.0), cell_capacity=32)
    params = TickParams.default(gravity=(0.0, -9.8))
    return s, params


def run_trajectory():
    s, params = scenario()
    step = make_step(s, neighbor_mode="grid")
    state = init_state(s)
    for _ in range(30):
        state = step(state, params)
    return state


def test_golden_trajectory():
    state = run_trajectory()
    pos = np.asarray(state.position)
    vel = np.asarray(state.velocity)
    dens = np.asarray(state.density)
    if not os.path.exists(GOLDEN) or os.environ.get("REGEN_GOLDEN"):
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        np.savez(GOLDEN, position=pos, velocity=vel, density=dens)
        pytest.skip("golden snapshot (re)generated — commit it")
    with np.load(GOLDEN) as z:
        np.testing.assert_allclose(pos, z["position"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(vel, z["velocity"], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(dens, z["density"], rtol=1e-5)


GOLDEN_RESIDENT = os.path.join(os.path.dirname(__file__), "golden",
                               "resident_512_s30.npz")


@pytest.mark.slow
def test_golden_trajectory_resident():
    """Same scenario through the resident engine: regression protection beyond parity-vs-dense — a snapshot
    pins the absolute trajectory."""
    from tpufluid.ops import resident

    s, params = scenario()
    gs = resident.init_grid_state(s)
    step = resident.make_grid_step(s)
    for _ in range(30):
        gs = step(gs, params)
    assert int(gs.lost) == 0
    ps, live = resident.to_particles(gs, s)
    assert int(live) == 512
    pos = np.asarray(ps.position)[:512]
    vel = np.asarray(ps.velocity)[:512]
    order = np.lexsort((pos[:, 1], pos[:, 0]))
    pos, vel = pos[order], vel[order]
    if not os.path.exists(GOLDEN_RESIDENT) or os.environ.get("REGEN_GOLDEN"):
        os.makedirs(os.path.dirname(GOLDEN_RESIDENT), exist_ok=True)
        np.savez(GOLDEN_RESIDENT, position=pos, velocity=vel)
        pytest.skip("golden snapshot (re)generated — commit it")
    with np.load(GOLDEN_RESIDENT) as z:
        np.testing.assert_allclose(pos, z["position"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(vel, z["velocity"], rtol=1e-4, atol=1e-3)
