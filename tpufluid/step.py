"""The simulation step: ONE jitted pure function.

Replaces the reference's per-tick dispatch schedule
(``FluidSimulation::tick``, ``src/simulation.rs:459-539``): the five WGSL
kernels + ~153 bitonic sort dispatches (compute.wgsl, sort.wgsl) collapse
into a single ``step(state, params[, forcefield]) -> state`` that XLA fuses
end-to-end with zero host round-trips.

Pipeline (same order as src/simulation.rs:502-538):
  predict -> cell keys -> sort+bin -> density -> forces+integrate

The returned state is in cell-sorted order (the reference likewise permutes
its particle buffer in place each tick; particles carry no identity).

Three neighbor modes:
  * "grid":  fixed-shape 3x3-cell windows over the sorted array
  * "naive": all-pairs candidates (the O(N^2) oracle for tests)
  * "dense": the sorted particles scattered into a [Gy, K, Gx] slot grid,
    3x3 stencil by whole-grid rolls (ops.dense)
"grid" and "naive" share every line of physics (tpufluid.ops.pairs).
Because masked candidates contribute exactly +0.0 and both modes iterate
neighbors in ascending sorted order, their f32 sums are bitwise identical
(as long as cell_capacity is not exceeded) — the central correctness test.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .params import EPSILON, MAX_SPEED, SimSettings, TickParams
from .state import ParticleState
from .ops import grid as gridops
from .ops import pairs
from .ops import prng


def predict_positions(position, velocity, delta, settings: SimSettings):
    """predicted = pos + vel*dt, clamped to the half-bounds box
    (compute.wgsl:8-30)."""
    bounds_half = jnp.asarray(settings.size, jnp.float32) * 0.5
    pred = position + velocity * delta
    over = jnp.abs(pred) > bounds_half
    return jnp.where(over, bounds_half * jnp.sign(pred), pred)


def sample_force_field(predicted, forcefield, settings: SimSettings):
    """Sample the obstacle push-out field at predicted positions
    (compute.wgsl:127-132 semantics, including the 2x pixel_to_world scale).

    forcefield: f32[H, W, 2] push-out vectors in *pixel* units.
    Returns (force_pixels [N,2], force_world [N,2]).
    """
    bounds = jnp.asarray(settings.size, jnp.float32)
    tex = jnp.asarray(
        [settings.texture_size[0], settings.texture_size[1]], jnp.float32
    )
    uv = predicted / bounds + 0.5
    texel = (uv * tex).astype(jnp.int32)
    tx = jnp.clip(texel[..., 0], 0, settings.texture_size[0] - 1)
    ty = jnp.clip(texel[..., 1], 0, settings.texture_size[1] - 1)
    force = forcefield[ty, tx]
    # Reference uses (bounds * 2) / texture_size (compute.wgsl:131) — kept.
    pixel_to_world = (bounds * 2.0) / tex
    return force, force * pixel_to_world


def _apply_force_field(position, velocity, predicted, forcefield, damping,
                       settings: SimSettings):
    """Push-out + normal-velocity damping (compute.wgsl:127-140)."""
    force, force_world = sample_force_field(predicted, forcefield, settings)
    hit = (force[..., 0] != 0.0) | (force[..., 1] != 0.0)
    norm = jnp.linalg.norm(force, axis=-1, keepdims=True)
    safe = jnp.where(norm == 0.0, 1.0, norm)
    nhat = force / safe
    new_pos = position + force_world
    vn = jnp.sum(velocity * nhat, axis=-1, keepdims=True)
    new_vel = velocity - (1.0 - damping) * vn * nhat
    position = jnp.where(hit[..., None], new_pos, position)
    velocity = jnp.where(hit[..., None], new_vel, velocity)
    return position, velocity


def _integrate(position, velocity, predicted, density, accel, params: TickParams,
               settings: SimSettings, forcefield: Optional[jax.Array],
               x_boundary: str = "bounce"):
    """Velocity + position update half of move_particle (compute.wgsl:95-155)."""
    dt = params.delta
    velocity = velocity + (accel / density[..., None]) * dt
    velocity = velocity + params.gravity * dt

    # Mouse impulse (compute.wgsl:99-108): dir = diff/dist^2, scaled by
    # power * state * (dist/radius).
    diff = params.mouse_pos - predicted
    dist = jnp.linalg.norm(diff, axis=-1)
    safe = jnp.where(dist == 0.0, 1.0, dist)
    impulse = (
        diff / (safe * safe)[..., None]
        * (params.mouse_force_power
           * params.mouse_state.astype(jnp.float32)
           * (dist / params.mouse_force_radius))[..., None]
    )
    # dist==0 under an active press is NaN in the reference (0/0); the NaN
    # reset below then zeroes the velocity. Reproduce that explicitly.
    impulse = jnp.where(
        (dist == 0.0)[..., None], jnp.float32(jnp.nan), impulse
    )
    apply = (params.mouse_state != 0) & (dist <= params.mouse_force_radius)
    velocity = jnp.where(apply[..., None], velocity + impulse, velocity)

    # NaN reset: if ANY component is NaN, zero the whole velocity
    # (compute.wgsl:113-116).
    nan_any = jnp.any(jnp.isnan(velocity), axis=-1, keepdims=True)
    velocity = jnp.where(nan_any, 0.0, velocity)

    # Speed clamp at 500 (compute.wgsl:118-122). The denominator is
    # where-guarded so the masked branch never forms 0/0 (checkify
    # hygiene — utils.debugging.checked_step runs with nan_checks);
    # results are bitwise identical (the guarded lane is discarded).
    speed = jnp.linalg.norm(velocity, axis=-1, keepdims=True)
    fast = speed > MAX_SPEED
    velocity = jnp.where(
        fast, velocity / jnp.where(fast, speed, 1.0) * MAX_SPEED, velocity
    )

    position = position + velocity * dt

    if forcefield is not None:
        position, velocity = _apply_force_field(
            position, velocity, predicted, forcefield,
            params.damping_factor, settings,
        )

    # Boundary clamp with per-axis bounce v *= -damping (compute.wgsl:143-153);
    # "wrap" variant teleports across the x walls with velocity untouched
    # (shaders/compute.wgsl:145-146).
    bounds_half = jnp.asarray(settings.size, jnp.float32) * 0.5
    out = jnp.abs(position) > bounds_half
    if x_boundary == "wrap":
        wrapped_x = jnp.where(
            out[..., 0], -bounds_half[0] * jnp.sign(position[..., 0]),
            position[..., 0],
        )
        clamped_y = jnp.where(
            out[..., 1], bounds_half[1] * jnp.sign(position[..., 1]),
            position[..., 1],
        )
        position = jnp.stack([wrapped_x, clamped_y], axis=-1)
        vy = jnp.where(out[..., 1], velocity[..., 1] * -params.damping_factor,
                       velocity[..., 1])
        velocity = jnp.stack([velocity[..., 0], vy], axis=-1)
    else:
        position = jnp.where(out, bounds_half * jnp.sign(position), position)
        velocity = jnp.where(out, velocity * -params.damping_factor, velocity)
    return position, velocity


def make_step(settings: SimSettings, *, neighbor_mode: str = "grid",
              surface_tension: bool = False, has_force_field: bool = False,
              x_boundary: str = "bounce",
              adaptive_subsampling: bool = False):
    """Build the jitted step function for fixed settings.

    Returns ``step(state, params)`` or ``step(state, params, forcefield)``
    if ``has_force_field`` (forcefield: f32[H, W, 2] pixel push-out vectors
    from tpufluid.ops.forcefield).

    Variant flags reproduce the reference's forked experimental shaders
    (SURVEY.md section 2.12):

    * ``x_boundary="wrap"``: teleport-wrap at the x walls instead of bounce
      (shaders/compute.wgsl:145-146); y keeps the bounce.
    * ``adaptive_subsampling``: the pressure pass strides over each cell's
      particle run by 1/5/13 as the particle's density crosses 150/200
      (shaders/compute.wgsl:170-174,195) — an accuracy-for-speed knob for
      highly compressed regions.
    """
    if neighbor_mode not in ("grid", "naive", "dense"):
        raise ValueError(f"unknown neighbor_mode {neighbor_mode!r}")
    if x_boundary not in ("bounce", "wrap"):
        raise ValueError(f"unknown x_boundary {x_boundary!r}")

    norms = settings.kernel_norms()
    h = jnp.float32(settings.smoothing_radius)
    sqr_radius = jnp.float32(settings.sqr_radius)

    def step(state: ParticleState, params: TickParams,
             forcefield: Optional[jax.Array] = None) -> ParticleState:
        frame = state.tick + jnp.uint32(1)

        # 1. predict (compute.wgsl:8-30)
        pred = predict_positions(
            state.position, state.velocity, params.delta, settings
        )
        # 2. cell keys (compute.wgsl:33-42)
        cells = gridops.cell_id(pred, settings)
        # 3. sort + segment starts (replaces sort.wgsl + compute.wgsl:45-56)
        binning = gridops.bin_particles(cells, settings)
        perm = binning.perm
        n = perm.shape[0]
        sorted_idx = jnp.arange(n, dtype=jnp.int32)
        if neighbor_mode == "dense":
            # scatter into the dense cell grid, 3x3 stencil via rolls
            # (ops.dense); column-oriented throughout
            from .ops import dense as denseops
            # ONE wide row gather applies the sort permutation to all six
            # columns at once
            src = jnp.concatenate(
                [pred, state.velocity, state.position], axis=1)  # [N, 6]
            g6 = src[binning.perm]
            pxs, pys = g6[:, 0], g6[:, 1]
            vxs, vys = g6[:, 2], g6[:, 3]
            dens, fpx, fpy, fvx, fvy, _ = denseops.dense_forces_cols(
                pxs, pys, vxs, vys, binning.sorted_cells, settings, params,
                norms, frame, surface_tension=surface_tension,
                adaptive_subsampling=adaptive_subsampling,
            )
            accel = jnp.stack([fpx + fvx, fpy + fvy], axis=-1)
            pred_sc = g6[:, 0:2]
            vel_sc = g6[:, 2:4]
            pos_sc = g6[:, 4:6]
            ff = forcefield if has_force_field else None
            new_pos, new_vel = _integrate(
                pos_sc, vel_sc, pred_sc, dens, accel, params, settings, ff,
                x_boundary=x_boundary,
            )
            return ParticleState(
                position=new_pos, predicted=pred_sc, velocity=new_vel,
                density=dens, cell=binning.sorted_cells.astype(jnp.uint32),
                tick=frame,
            )
        pos_s = state.position[perm]
        vel_s = state.velocity[perm]
        pred_s = pred[perm]
        if neighbor_mode == "grid":
            win = gridops.neighbor_windows(
                binning.sorted_cells, binning.cell_start, settings
            )
            nb_idx = win.idx.reshape(n, -1)
            nb_valid = win.valid.reshape(n, -1)
        else:
            nb_idx = jnp.broadcast_to(sorted_idx[None, :], (n, n))
            nb_valid = jnp.ones((n, n), bool)

        nb_pred = pred_s[nb_idx]

        # 4. density, with the EPSILON and 0.1 floors applied in reference
        # order (funcs.wgsl:202, compute.wgsl:70)
        dens = pairs.density(pred_s, nb_pred, nb_valid, params.mass, h)
        dens = jnp.maximum(dens, EPSILON)
        dens = jnp.maximum(dens, 0.1)

        # 5. forces (compute.wgsl:160-299)
        nb_dens = dens[nb_idx]
        nb_vel = vel_s[nb_idx]
        # tie-break seed: position hash (shard-invariant; see
        # prng.position_seed) + frame salt, cf. compute.wgsl:161
        rand_seed = prng.position_seed(pred_s) + frame * jnp.uint32(69)
        nb_valid_pressure = nb_valid
        if adaptive_subsampling:
            # applies in naive mode too: candidates are in sorted order, so
            # the rank-in-cell stride is identical to the windowed path
            # stride each cell run by 1/5/13 as the querying particle's
            # density crosses 150/200 (shaders/compute.wgsl:170-174,195)
            inc = (
                jnp.uint32(1)
                + jnp.where(dens >= 150.0, jnp.uint32(4), jnp.uint32(0))
                + jnp.where(dens >= 200.0, jnp.uint32(8), jnp.uint32(0))
            )
            slot_cell = binning.sorted_cells[nb_idx]
            off_in_cell = (
                nb_idx - binning.cell_start[slot_cell]
            ).astype(jnp.uint32)
            nb_valid_pressure = nb_valid & (off_in_cell % inc[:, None] == 0)

        f_pressure = pairs.pressure_force(
            sorted_idx, pred_s, dens, nb_idx, nb_pred, nb_dens,
            nb_valid_pressure,
            params.pressure_constant, params.rest_density, h, sqr_radius,
            jnp.float32(norms.spiky_derivative), rand_seed,
        )
        f_viscosity = pairs.viscosity_force(
            sorted_idx, pred_s, vel_s, nb_idx, nb_pred, nb_vel, nb_dens,
            nb_valid, params.viscosity_coefficient, h, sqr_radius,
            jnp.float32(norms.viscosity),
        )
        accel = f_pressure + f_viscosity
        if surface_tension:
            # Optional: the reference implements this but leaves the call
            # commented out (compute.wgsl:92); seed per compute.wgsl:406 —
            # WGSL u32(f32) saturates negatives to 0, made explicit here so
            # every engine (XLA grid/dense, Pallas) computes the same seed.
            st_seed = (
                jnp.maximum(pred_s[:, 0], 0.0).astype(jnp.int32)
                .astype(jnp.uint32) * jnp.uint32(324)
                + frame * jnp.uint32(5632)
            )
            accel = accel + pairs.surface_tension(
                pred_s, nb_pred, nb_dens, nb_valid, params.mass, h,
                sqr_radius, params.surface_tension_threshold,
                params.surface_tension_coefficient, st_seed,
            )

        # 6. integrate (compute.wgsl:95-155)
        ff = forcefield if has_force_field else None
        new_pos, new_vel = _integrate(
            pos_s, vel_s, pred_s, dens, accel, params, settings, ff,
            x_boundary=x_boundary,
        )

        return ParticleState(
            position=new_pos,
            predicted=pred_s,
            velocity=new_vel,
            density=dens,
            cell=binning.sorted_cells.astype(jnp.uint32),
            tick=frame,
        )

    if has_force_field:
        return jax.jit(step)
    return jax.jit(lambda state, params: step(state, params, None))


_MULTI_STEP_CACHE: dict = {}


def make_multi_step(settings: SimSettings, n_steps: int, **kw):
    """``run(state, params[, forcefield]) -> state`` advancing ``n_steps``
    ticks in ONE device program via ``lax.scan``. Memoized on all
    (hashable) arguments, like ops.resident.make_grid_multi_step —
    FluidApp.run calls this per burst and must not mint a fresh jit
    cache entry each time.

    This replaces the reference's per-frame tick burst
    (src/main.rs:137-147): instead of N host-dispatched encoder submissions,
    the whole burst is a single compiled loop with no host round-trips.
    """
    key = (settings, n_steps, tuple(sorted(kw.items())))
    hit = _MULTI_STEP_CACHE.get(key)
    if hit is not None:
        return hit
    has_ff = kw.get("has_force_field", False)
    # make_step returns a jitted fn; calling it inside scan is fine (the
    # inner jit inlines under trace).
    step = make_step(settings, **kw)

    if has_ff:
        @jax.jit
        def run(state, params, forcefield):
            def body(s, _):
                return step(s, params, forcefield), None
            out, _ = jax.lax.scan(body, state, None, length=n_steps)
            return out
    else:
        @jax.jit
        def run(state, params):
            def body(s, _):
                return step(s, params), None
            out, _ = jax.lax.scan(body, state, None, length=n_steps)
            return out
    _MULTI_STEP_CACHE[key] = run
    return run
