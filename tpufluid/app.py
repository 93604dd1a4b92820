"""Headless app shell: the reference's event loop as a driver API.

Rebuilds reference component 2.14 (src/main.rs:20-318) without windowing:
the Running/Render/Step/Stopped state machine, the fixed-timestep
accumulator with frame-drop bailout (src/main.rs:137-147), the offline
render mode's 16-ticks-per-frame cadence (src/main.rs:199-201), and the
restart button (src/renderer.rs:873-875). Hotkeys become methods
(Space -> toggle_running, N -> request_step, Enter -> start_render);
mouse input becomes set_mouse (src/main.rs:275-303 semantics, already in
world coordinates — no unprojection needed headless).
"""

from __future__ import annotations

import enum
import os
import time
from typing import Callable, Optional

import numpy as np

from .params import SimSettings, TickParams
from .state import init_state
from .step import make_step, make_multi_step
from .ops import forcefield as ff
from .ops import render as renderops
from .utils import io as ioutils
from .utils.profiling import StepTimer


class SimState(enum.Enum):
    RUNNING = "running"
    RENDER = "render"
    STEP = "step"
    STOPPED = "stopped"


class FluidApp:
    """Owns settings, tick params, obstacles, and the jitted step."""

    # Frame-drop bailout threshold (src/main.rs:143-146).
    FRAME_BUDGET = 1.0 / 90.0
    # Offline render cadence (src/main.rs:199-201).
    TICKS_PER_RENDER_FRAME = 16

    def __init__(self, settings: SimSettings = SimSettings(),
                 params: Optional[TickParams] = None,
                 objects: Optional[ff.Objects] = None,
                 strict_capacity: Optional[bool] = None,
                 capacity_policy: Optional[str] = None,
                 **step_kw):
        """capacity_policy (bounded engines: resident/dense):

        * ``"grow"`` (default) — never refuse and never lose mass: the
          cell capacity is auto-sized up front (params.
          suggest_cell_capacity) and, if a scene still out-compresses it,
          the resident engine regrows the slot axis and REPLAYS the ticks
          since the last loss-free audit (the grown-capacity trajectory
          is bitwise what an always-big-capacity run produces — kernel
          cost tracks occupancy, not capacity, so headroom is ~free).
          This matches the reference's unbounded per-cell loops
          (compute.wgsl:182-229), which never shed mass.
        * ``"strict"`` — refuse undersized scenes up front, raise on
          runtime loss (``strict_capacity=True`` legacy alias).
        * ``"fixed"`` — keep the given capacity; mass loss is counted
          (GridState.lost) and warned (``strict_capacity=False`` alias).
        """
        self.settings = settings
        self.params = params or TickParams.default()
        self.objects = objects if objects is not None else ff.Objects.empty()
        self._has_objects = self.objects.kind.shape[0] > 0
        self._resident = step_kw.get("neighbor_mode") == "resident"
        if capacity_policy is None:
            capacity_policy = ("strict" if strict_capacity
                               else "fixed" if strict_capacity is not None
                               else "grow")
        if capacity_policy not in ("grow", "strict", "fixed"):
            raise ValueError(f"unknown capacity_policy {capacity_policy!r}")
        self._capacity_policy = capacity_policy
        self._strict_capacity = capacity_policy == "strict"
        bounded = step_kw.get("neighbor_mode") in ("resident", "dense")
        if bounded and capacity_policy == "grow":
            from .params import suggest_cell_capacity
            import dataclasses
            if self._resident:
                # Start LEAN: capacity only needs to cover the spawn
                # lattice (suggest without params = rest occupancy);
                # the 256-tick loss audit + regrow-and-replay is the
                # backstop, and it reproduces the always-big-capacity
                # trajectory bitwise. Slot headroom is not free: the
                # rebin reads and writes every slot. Heavy-compression
                # scenes pay 1-2 regrow recompiles at startup instead.
                rec = suggest_cell_capacity(self.settings)
            else:
                # dense has no runtime regrow: size for the
                # modeled compression peak up front
                rec = suggest_cell_capacity(self.settings, self.params)
            if settings.cell_capacity < rec:
                settings = dataclasses.replace(settings, cell_capacity=rec)
                self.settings = settings
        elif bounded and capacity_policy == "strict":
            # fail fast instead of silently shedding mass (the reference's
            # unbounded loops never lose particles, compute.wgsl:182-229).
            # Refusal uses the raw estimate; the message shows the padded
            # recommendation.
            from .params import suggest_cell_capacity
            raw = suggest_cell_capacity(self.settings, self.params,
                                        safety=1.0, rounded=False)
            if settings.cell_capacity < raw:
                rec = suggest_cell_capacity(self.settings, self.params)
                raise ValueError(
                    f"cell_capacity={settings.cell_capacity} is undersized "
                    f"for this scene: gravity/EOS compression needs ~{rec} "
                    f"(suggest_cell_capacity). Raise cell_capacity, use "
                    f"neighbor_mode='grid', or pass capacity_policy='grow' "
                    f"(auto-size + regrow) / 'fixed' (accept counted mass "
                    f"loss, GridState.lost / health_check).")
        if self._resident:
            from .ops import resident as residentops
            self._residentops = residentops
            self._resident_kw = dict(
                x_boundary=step_kw.get("x_boundary") or "bounce",
                surface_tension=step_kw.get("surface_tension", False),
                adaptive_subsampling=step_kw.get(
                    "adaptive_subsampling", False))
            self._step = residentops.make_grid_step(
                settings, has_force_field=self._has_objects,
                **self._resident_kw)
            # NOTE: the state setter below builds _grid_state via
            # from_particles — no separate init_grid_state call needed.
            step_kw = {}
        else:
            self._step = make_step(
                settings, has_force_field=self._has_objects, **step_kw,
            )
        self._step_kw = step_kw
        self.state = init_state(settings)
        self.sim_state = SimState.STOPPED
        self.accumulator = 0.0
        self.timer = StepTimer()
        self.dropped_frames = 0
        self._forcefield = (
            ff.obstacle_force_field(self.objects, settings)
            if self._has_objects else None
        )

    # ---------------------------------------------------------------- control

    def toggle_running(self) -> None:  # Space (src/main.rs:246-254)
        if self.sim_state is SimState.STOPPED:
            self.accumulator = 0.0
            self.sim_state = SimState.RUNNING
        else:
            self.sim_state = SimState.STOPPED

    def request_step(self) -> None:  # N key (src/main.rs:255-257)
        self.sim_state = SimState.STEP

    def start_render(self) -> None:  # Enter key (src/main.rs:261-269)
        self.restart()
        self.sim_state = SimState.RENDER

    def restart(self) -> None:  # egui restart button (src/renderer.rs:873-875)
        # the state setter rebuilds _grid_state in resident mode
        self.state = init_state(self.settings)
        self.accumulator = 0.0
        self.n_regrows = 0  # session counter, scoped to the current run

    def set_mouse(self, pos=None, state: Optional[int] = None) -> None:
        """World-space impulse source: state -1 repel / +1 attract / 0 off."""
        import jax.numpy as jnp
        if pos is not None:
            self.params.mouse_pos = jnp.asarray(pos, jnp.float32)
        if state is not None:
            self.params.mouse_state = jnp.asarray(state, jnp.int32)

    def set_video_field(self, frames) -> None:
        """Drive the obstacle force field from grayscale frames
        (completes reference component 2.15 — its upload path was left
        commented out, src/main.rs:120-126). frames: u8[T, H, W]; each
        rendered frame in render_sequence consumes one video frame;
        ``tick`` uses the current one. Dark pixels (<=128) are obstacles."""
        import numpy as np
        from .native import distfield
        from .utils import io as ioutils

        frames = np.asarray(frames)
        if frames.ndim != 3:
            raise ValueError(f"expected u8[T, H, W], got {frames.shape}")
        th, tw = frames.shape[1:]
        if (tw, th) != tuple(self.settings.texture_size):
            raise ValueError(
                f"frame size {(tw, th)} != texture_size "
                f"{self.settings.texture_size}")
        import jax.numpy as jnp
        self._video_fields = [
            jnp.asarray(distfield.chamfer_push_field(f)) for f in frames
        ]
        self._video_index = 0
        self._has_objects = True
        self._rebuild_step(has_force_field=True)
        self._forcefield = self._video_fields[0]

    def advance_video_frame(self) -> None:
        if getattr(self, "_video_fields", None):
            self._video_index = (
                (self._video_index + 1) % len(self._video_fields))
            self._forcefield = self._video_fields[self._video_index]

    def _rebuild_step(self, has_force_field: bool) -> None:
        if self._resident:
            self._step = self._residentops.make_grid_step(
                self.settings, has_force_field=has_force_field,
                **self._resident_kw)
        else:
            self._step = make_step(self.settings,
                                   has_force_field=has_force_field,
                                   **self._step_kw)

    def set_objects(self, objects: ff.Objects) -> None:
        """Replace the obstacle set and recompute the force field on device."""
        self.objects = objects
        has = objects.kind.shape[0] > 0
        if has != self._has_objects:
            self._has_objects = has
            self._rebuild_step(has_force_field=has)
        self._forcefield = (
            ff.obstacle_force_field(objects, self.settings) if has else None
        )

    # ------------------------------------------------------------------ tick

    @property
    def state(self):
        """ParticleState view; materialized lazily from the grid in
        resident mode (conversion costs a sort — only pay on access)."""
        if self._resident and self._state_dirty:
            self._state, _ = self._residentops.to_particles(
                self._grid_state, self.settings)
            self._state_dirty = False
        return self._state

    @state.setter
    def state(self, value):
        self._state = value
        self._state_dirty = False
        if self._resident:
            self._grid_state = self._residentops.from_particles(
                value, self.settings)
            if getattr(self, "_capacity_policy", None) == "grow":
                # binning drops (a loaded/dense state can overfill cells
                # the spawn advisor never saw) regrow IMMEDIATELY — the
                # source particles are still in hand here, so nothing is
                # lost. One device sync per restart/load.
                import dataclasses
                while int(self._grid_state.lost) > 0:
                    k = self.settings.cell_capacity
                    new_k = -(-(k + max(8, k // 4)) // 8) * 8
                    if new_k > self.MAX_CELL_CAPACITY:
                        break  # leave the counted loss; audit will report
                    self.settings = dataclasses.replace(
                        self.settings, cell_capacity=new_k)
                    self._rebuild_step(has_force_field=self._has_objects)
                    self._grid_state = self._residentops.from_particles(
                        value, self.settings)
            # regrow-and-replay bookkeeping (capacity_policy="grow")
            self._snapshot = self._grid_state
            self._lost_baseline = None  # resolved lazily at first audit
            self._ticks_since_snapshot = 0
            self._ticks_since_audit = 0

    # ticks between runtime mass-loss audits (device->host sync each time)
    LOSS_CHECK_EVERY = 256
    LOSS_FRACTION = 1e-3

    # capacity regrow ceiling (slots/cell); beyond this a scene is
    # pathological for ANY per-cell layout — grid mode is the answer
    MAX_CELL_CAPACITY = 512

    def _raw_resident_step(self) -> None:
        if self._has_objects:
            self._grid_state = self._step(
                self._grid_state, self.params, self._forcefield)
        else:
            self._grid_state = self._step(self._grid_state, self.params)

    def tick(self) -> None:
        if self._resident:
            self._raw_resident_step()
            self._state_dirty = True
            self.timer.lap(self._grid_state)
            # host-side counters: int(tick) every step would sync the device
            self._ticks_since_snapshot = getattr(
                self, "_ticks_since_snapshot", 0) + 1
            self._ticks_since_audit = getattr(
                self, "_ticks_since_audit", 0) + 1
            if self._ticks_since_audit >= self.LOSS_CHECK_EVERY:
                self._ticks_since_audit = 0
                self._audit_loss()
            return
        if self._has_objects:
            self.state = self._step(self.state, self.params, self._forcefield)
        else:
            self.state = self._step(self.state, self.params)
        self.timer.lap(self._state)

    # burst sizes used by run(): a small fixed menu bounds the number of
    # lax.scan programs ever compiled per (settings, flags) combination
    _BURST_SIZES = (64, 16, 4, 1)

    def _dispatch_resident_burst(self, b: int) -> None:
        """One scan burst of ``b`` resident ticks (no audit bookkeeping)."""
        if b == 1:
            self._raw_resident_step()
            return
        run_fn = self._residentops.make_grid_multi_step(
            self.settings, b, has_force_field=self._has_objects,
            **self._resident_kw)
        if self._has_objects:
            self._grid_state = run_fn(
                self._grid_state, self.params, self._forcefield)
        else:
            self._grid_state = run_fn(self._grid_state, self.params)

    def run(self, n_steps: int, max_burst: int = 64) -> None:
        """Advance ``n_steps`` ticks in ``lax.scan`` bursts — one device
        dispatch per burst instead of one per tick.

        This is the reference's per-frame tick burst
        (src/main.rs:137-147) without the N encoder submissions: one
        device dispatch per burst.

        Equivalent to ``tick()`` in a loop, with two burst-granularity
        contracts (the same ones the grow policy's regrow replay already
        documents): live tuning applies at burst boundaries, and the
        runtime mass-loss audit still runs every <= LOSS_CHECK_EVERY
        ticks, aligned to a burst boundary.
        """
        if n_steps <= 0:
            return
        if max_burst < 1:
            raise ValueError("max_burst must be >= 1")
        remaining = n_steps
        if not self._resident:
            while remaining:
                b = next(s for s in self._BURST_SIZES
                         if s <= max_burst and s <= remaining)
                run_fn = make_multi_step(
                    self.settings, b, has_force_field=self._has_objects,
                    **self._step_kw)
                if self._has_objects:
                    self.state = run_fn(
                        self.state, self.params, self._forcefield)
                else:
                    self.state = run_fn(self.state, self.params)
                self.timer.laps(self._state, b)
                remaining -= b
            return
        while remaining:
            room = self.LOSS_CHECK_EVERY - self._ticks_since_audit
            b = next(s for s in self._BURST_SIZES
                     if s <= max_burst and s <= remaining
                     and s <= max(room, 1))
            self._dispatch_resident_burst(b)
            self._state_dirty = True
            self.timer.laps(self._grid_state, b)
            self._ticks_since_snapshot = getattr(
                self, "_ticks_since_snapshot", 0) + b
            self._ticks_since_audit = getattr(
                self, "_ticks_since_audit", 0) + b
            remaining -= b
            if self._ticks_since_audit >= self.LOSS_CHECK_EVERY:
                self._ticks_since_audit = 0
                self._audit_loss()

    def _audit_loss(self) -> None:
        """Runtime mass-loss audit (one device->host sync): the static
        advisor models equilibrium + impact; this is the backstop for
        scenes that out-compress it. Under capacity_policy="grow" a lossy
        burst is REPLAYED from the last loss-free snapshot at a wider
        capacity — the result is bitwise the always-big-capacity
        trajectory, so no mass is ever lost (reference semantics,
        compute.wgsl:182-229)."""
        lost = int(self._grid_state.lost)
        lost0 = getattr(self, "_lost_baseline", None)
        if lost0 is None:  # first audit: the snapshot's own count
            lost0 = int(self._snapshot.lost)
        if lost > lost0 and self._capacity_policy == "grow":
            self._regrow_and_replay(lost0)
            return
        if lost > lost0:  # strict / fixed policies: report
            if lost > self.LOSS_FRACTION * self.settings.particle_count:
                msg = (
                    f"resident engine shed {lost} of "
                    f"{self.settings.particle_count} particles "
                    f"(cell_capacity {self.settings.cell_capacity} "
                    f"exceeded by compression): raise cell_capacity, "
                    f"use capacity_policy='grow', or neighbor_mode='grid'")
                if self._strict_capacity:
                    raise RuntimeError(msg)
                import warnings
                warnings.warn(msg, RuntimeWarning)
        self._snapshot = self._grid_state
        self._lost_baseline = lost
        self._ticks_since_snapshot = 0
        if self._capacity_policy == "grow":
            self._maybe_shrink()

    # shrink-back hysteresis: one tile down after this many consecutive
    # clean audits whose peak occupancy clears the smaller capacity by
    # the margin (grow costs a replay — don't flap on the boundary)
    SHRINK_AFTER_AUDITS = 2
    SHRINK_MARGIN = 2

    def _maybe_shrink(self) -> None:
        """Reclaim capacity headroom left by a transient-compression
        regrow: slot tiles cost no pair work (the physics loops stop at
        the occupancy) but the rebin reads and writes all K slots."""
        import dataclasses
        k = self.settings.cell_capacity
        new_k = k - 8
        if new_k < 8:
            self._shrink_streak = 0
            return
        occ = int(self._grid_state.occ_row.max())
        if occ > new_k - self.SHRINK_MARGIN:
            self._shrink_streak = 0
            return
        self._shrink_streak = getattr(self, "_shrink_streak", 0) + 1
        if self._shrink_streak < self.SHRINK_AFTER_AUDITS:
            return
        self._shrink_streak = 0
        self.settings = dataclasses.replace(
            self.settings, cell_capacity=new_k)
        self._rebuild_step(has_force_field=self._has_objects)
        self._grid_state = self._residentops.shrink_capacity(
            self._grid_state, new_k)
        self._snapshot = self._grid_state
        self._state_dirty = True

    def _regrow_and_replay(self, lost0: int) -> None:
        import dataclasses
        self._shrink_streak = 0
        replay = self._ticks_since_snapshot
        # One EVENT per overflow, regardless of how many capacity widenings
        # the escalation loop below needs (metrics() documents this).
        self.n_regrows = getattr(self, "n_regrows", 0) + 1
        while True:
            k = self.settings.cell_capacity
            new_k = -(-(k + max(8, k // 4)) // 8) * 8
            if new_k > self.MAX_CELL_CAPACITY:
                raise RuntimeError(
                    f"capacity regrow exceeded {self.MAX_CELL_CAPACITY} "
                    f"slots/cell; use neighbor_mode='grid' for this scene")
            self.settings = dataclasses.replace(
                self.settings, cell_capacity=new_k)
            self._rebuild_step(has_force_field=self._has_objects)
            self._grid_state = self._residentops.grow_capacity(
                self._snapshot, new_k)
            # replay with CURRENT params: live tuning mid-burst replays
            # with the latest values (documented; audits are 256 ticks)
            for _ in range(replay):
                self._raw_resident_step()
            self._state_dirty = True
            lost = int(self._grid_state.lost)
            if lost <= lost0:
                self._snapshot = self._grid_state
                self._lost_baseline = lost
                self._ticks_since_snapshot = 0
                return

    def advance(self, wall_dt: float) -> int:
        """Fixed-timestep accumulator: run as many ticks as wall time owes,
        bailing out if the burst exceeds the frame budget
        (src/main.rs:137-147). Returns ticks executed."""
        if self.sim_state is SimState.STOPPED:
            return 0
        if self.sim_state is SimState.STEP:
            self.tick()
            self.sim_state = SimState.STOPPED
            return 1

        delta = float(self.params.delta)
        if delta == 0.0:
            return 0
        self.accumulator += wall_dt
        ticks = 0
        start = time.perf_counter()
        while self.accumulator > delta:
            self.tick()
            self.accumulator -= delta
            ticks += 1
            if time.perf_counter() - start > self.FRAME_BUDGET:
                self.dropped_frames += int(self.accumulator / delta)
                self.accumulator = 0.0
                break
        return ticks

    # ---------------------------------------------------------------- render

    def render_frame(self, width=960, height=540,
                     camera: Optional[renderops.Camera] = None,
                     mode: str = "metaball"):
        """``metaball``: fluid surface. In resident mode it shades straight
        off the slot grid (ops.render_grid -- no to_particles sort, no
        re-binning); pass ``metaball_exact`` for the per-pixel binned
        renderer. ``particles``: point sprites."""
        cam = camera or renderops.Camera(
            view_size=(self.settings.size[0], self.settings.size[0] * height / width)
        )
        from .ops import render_binned
        if mode == "metaball" and self._resident:
            from .ops import render_grid
            return render_grid.render_metaball_grid(
                self._grid_state, self.settings, width, height, cam)
        if mode in ("metaball", "metaball_exact"):
            return render_binned.render_metaball_binned(
                self.state, self.settings, width, height, cam)
        if mode == "particles":
            return render_binned.render_particles_binned(
                self.state, self.settings, width, height, cam)
        raise ValueError(f"unknown render mode {mode!r}")

    def iter_frames(self, frames: int, width=960, height=540,
                    mode: str = "metaball",
                    progress: Optional[Callable[[int], None]] = None):
        """Offline render mode (src/main.rs:153-216) as a generator:
        16 ticks per frame, yields rgba8[H, W, 4] per frame."""
        self.sim_state = SimState.RENDER
        for i in range(frames):
            # One video frame per output frame, starting at frame 0: the
            # reference decodes one packet per rendered frame from the start
            # (src/main.rs:154-197), and set_video_field already primed
            # _forcefield with _video_fields[0] — so advance AFTER the frame.
            self.run(self.TICKS_PER_RENDER_FRAME)
            frame = self.render_frame(width, height, mode=mode)
            yield np.asarray(renderops.to_rgba8(frame))
            self.advance_video_frame()
            if progress:
                progress(i)
        self.sim_state = SimState.STOPPED

    def render_sequence(self, out_dir: str, frames: int, width=960, height=540,
                        mode: str = "metaball",
                        progress: Optional[Callable[[int], None]] = None):
        """Offline render to PNGs (one per frame); see iter_frames for the
        underlying cadence, render_mp4 for a PNG-free encode."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for i, rgba8 in enumerate(self.iter_frames(
                frames, width, height, mode, progress)):
            path = os.path.join(out_dir, f"frame_{i:05d}.png")
            paths.append(ioutils.write_png(path, rgba8))
        return paths

    def render_mp4(self, path: str, frames: int, width=960, height=540,
                   mode: str = "metaball", fps: int = 30,
                   progress: Optional[Callable[[int], None]] = None) -> str:
        """Offline render straight to an mp4 — no PNG intermediates."""
        ioutils.save_mp4(
            path, self.iter_frames(frames, width, height, mode, progress),
            fps=fps)
        return path

    # -------------------------------------------------------------- metrics

    def metrics(self, deep: bool = False) -> dict:
        """Numeric observability snapshot (the reference exports none —
        SURVEY.md section 5): tick, steps/s, drop counters.

        The default is CHEAP — host counters plus two device scalars
        (tick, lost); safe to call every frame. ``deep=True`` adds the
        full ``health_check`` audit (NaN counts, bounds, occupancy vs
        capacity, max speed), which re-bins the particle set on host and,
        in resident mode, materializes ``state`` (a full slot-space sort)
        — more expensive than a 1M step; use it for debugging, not in
        the hot loop."""
        if self._resident:
            tick = int(self._grid_state.tick)
        else:
            tick = int(self._state.tick)
        out = dict(
            tick=tick,
            sim_state=self.sim_state.value,
            steps_per_sec=self.timer.last_rate,
            particle_steps_per_sec=(
                self.timer.last_rate * self.settings.particle_count),
            dropped_frames=self.dropped_frames,
        )
        if self._resident:
            out["lost_particles"] = int(self._grid_state.lost)
            # n_regrows counts overflow EVENTS (one per regrow-and-replay,
            # however many capacity widenings the escalation needed). It is
            # a session counter: restart() zeroes it and it is not persisted
            # in checkpoints (load() starts a fresh session).
            out["n_regrows"] = getattr(self, "n_regrows", 0)
            out["cell_capacity"] = self.settings.cell_capacity
        if deep:
            from .utils.profiling import health_check
            out.update(health_check(self.state, self.settings))
        return out

    # ------------------------------------------------------------ checkpoint

    def save(self, path: str) -> None:
        ioutils.save_checkpoint(path, self.state)

    def load(self, path: str) -> None:
        self.state = ioutils.load_checkpoint(path)
