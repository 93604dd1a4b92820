"""Live parameter tuning with zero recompiles.

The reference's egui panel mutates 11+ tick parameters every frame by
rewriting a uniform buffer (src/simulation.rs:470-499). The equivalent here:
every TickParams field is a traced scalar, so changing ANY of them reuses
the same compiled executable — asserted here via the jit cache size.
"""

import jax.numpy as jnp
import numpy as np

from tpufluid import SimSettings, TickParams, init_state, make_step


def test_all_tick_params_change_without_recompile():
    s = SimSettings(particle_count=128, size=(8.0, 8.0), cell_capacity=16)
    step = make_step(s)
    state = init_state(s)
    state = step(state, TickParams.default())
    assert step._cache_size() == 1

    variants = [
        TickParams.default(delta=1 / 60.0),
        TickParams.default(gravity=(3.0, -9.8)),
        TickParams.default(mass=2.0),
        TickParams.default(pressure_constant=80.0),
        TickParams.default(rest_density=1.5),
        TickParams.default(damping_factor=0.5),
        TickParams.default(viscosity_coefficient=5.0),
        TickParams.default(mouse_force_radius=2.0, mouse_force_power=300.0,
                           mouse_pos=(1.0, -1.0), mouse_state=1),
        TickParams.default(surface_tension_threshold=0.5,
                           surface_tension_coefficient=10.0),
    ]
    for p in variants:
        state = step(state, p)
    assert step._cache_size() == 1, "a TickParams change forced a recompile"
    assert np.all(np.isfinite(np.asarray(state.position)))


def test_mid_run_parameter_change_affects_physics():
    s = SimSettings(particle_count=128, size=(8.0, 8.0), cell_capacity=16)
    step = make_step(s)
    state = init_state(s)
    for _ in range(3):
        state = step(state, TickParams.default())
    # flip gravity on mid-run: same executable, different dynamics
    before = np.asarray(state.velocity)[:, 1].mean()
    for _ in range(10):
        state = step(state, TickParams.default(gravity=(0.0, -50.0)))
    after = np.asarray(state.velocity)[:, 1].mean()
    assert after < before - 1.0
