"""NaN/Inf provenance debugging.

The reference's only NaN story is the silent in-kernel velocity reset
(compute.wgsl:113-116) — a blowup leaves no trace of WHERE it started.
Two diagnosis tools:

* ``checked_step``: wraps an [N]-engine step in
  ``jax.experimental.checkify`` with float checks — the returned error
  names the first NaN/Inf-producing primitive with a traceback into the
  step source. (Pallas kernels are opaque to checkify, so this covers
  the ``dense``/``grid``/``naive`` engines; the resident engine gets the
  stage-level audit below.)
* ``diagnose_resident_step``: runs ONE resident step stage by stage
  (rebin -> far-mover reinsert -> density -> forces+integrate) and
  reports per-stage finiteness / occupancy / loss, localizing a blowup
  to the stage that first produced a non-finite value.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from ..params import SimSettings, TickParams
from ..step import make_step


def checked_step(settings: SimSettings, neighbor_mode: str = "dense",
                 **step_kw):
    """``step(state, params) -> (err, new_state)`` with checkify float
    tracking. ``err.throw()`` raises with the first NaN/Inf site.

    Example::

        step = checked_step(settings)
        err, state = step(state, params)
        err.throw()   # no-op when clean
    """
    base = make_step(settings, neighbor_mode=neighbor_mode, **step_kw)
    # nan_checks, not float_checks: the step math intentionally divides
    # by where-guarded denominators (inf is produced then masked, like
    # the reference's own guarded divisions) — only an actual NaN is a
    # defect worth provenance.
    errs = checkify.nan_checks | checkify.user_checks
    return jax.jit(checkify.checkify(base, errors=errs))


def diagnose_resident_step(gs, params: TickParams, settings: SimSettings,
                           forcefield: Optional[jax.Array] = None) -> dict:
    """Stage-level audit of one resident step; host-side, not jitted.

    Returns {stage: {"finite": bool, "occ_max": int, ...}} for stages
    ``input``, ``rebin``, ``density``, ``forces``. The first stage with
    ``finite == False`` is where the blowup entered. The physics stages
    are the backend's own (ops.resident.physics_impl).
    """
    from ..ops import resident, slot_physics

    settings = resident.pad_capacity(settings)
    density, forces_integrate = resident.physics_stages(
        resident.physics_impl())
    report = {}

    def stat(name, px, py, vx, vy, occ_row, extra=None):
        live = px < slot_physics.SENTINEL_HALF
        z = jnp.zeros_like(px)
        finite = bool(
            jnp.all(jnp.isfinite(jnp.where(live, px, z)))
            & jnp.all(jnp.isfinite(jnp.where(live, py, z)))
            & jnp.all(jnp.isfinite(jnp.where(live, vx, z)))
            & jnp.all(jnp.isfinite(jnp.where(live, vy, z))))
        row = dict(
            finite=finite,
            live=int(jnp.sum(live)),
            occ_max=int(jnp.max(occ_row)),
            speed_max=float(jnp.max(jnp.where(
                live, jnp.abs(vx) + jnp.abs(vy), 0.0))),
        )
        if extra:
            row.update(extra)
        report[name] = row

    stat("input", gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row)

    px, py, vx, vy, occ_row, far_n, over_n = slot_physics.rebin(
        gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, params.delta, settings)
    stat("rebin", px, py, vx, vy, occ_row,
         extra=dict(far=int(jnp.sum(far_n)), over=int(jnp.sum(over_n))))

    pres, invr = density(
        px, py, vx, vy, occ_row, params.mass, params.delta,
        params.pressure_constant, params.rest_density, settings)
    live = px < slot_physics.SENTINEL_HALF
    report["density"] = dict(
        finite=bool(jnp.all(jnp.isfinite(jnp.where(live, pres, 0.0)))
                    & jnp.all(jnp.isfinite(jnp.where(live, invr, 0.0)))),
        pres_max=float(jnp.max(jnp.where(live, pres, 0.0))),
        rho_max=float(jnp.max(jnp.where(live, 1.0 / invr, 0.0))),
    )

    ff_cells = None
    if forcefield is not None:
        gxp = px.shape[-1]
        ff_cells = resident.forcefield_cells(forcefield, settings, gxp)
    npx, npy, nvx, nvy = forces_integrate(
        px, py, vx, vy, pres, invr, occ_row, params, settings,
        gs.tick + jnp.uint32(1), ff_cells=ff_cells)
    stat("forces", npx, npy, nvx, nvy, occ_row)
    return report
