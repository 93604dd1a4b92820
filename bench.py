"""Benchmark harness.

Prints ONE JSON line: {"metric": "...", "value": N, "unit": "..."} --
particle-steps/sec at 1M particles on one device (the reference publishes
no numbers of its own; its implied real-time throughput is ~1.2e7
particle-steps/s -- 100k particles at 120 Hz, src/main.rs:50 +
src/renderer.rs:375).

Run directly (`python bench.py`) for the headline line,
`python bench.py --all` / `python -m tpufluid bench` for the full ladder,
`python bench.py --physics-ab` for the resident physics kernels against
the plain stages.
"""

import argparse
import json
import sys
import time

import jax

from tpufluid.utils.cache import configure_compile_cache


def _timeit(fn, state, params, *extra, warmup=3, iters=20, repeats=1):
    """Mean seconds per call; with ``repeats`` > 1 also the per-repeat
    sample list (each repeat times ``iters`` calls), so callers can
    report a spread instead of a bare point."""
    for _ in range(warmup):
        state = fn(state, params, *extra)
    jax.block_until_ready(state)
    samples = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        for _ in range(iters):
            state = fn(state, params, *extra)
        jax.block_until_ready(state)
        samples.append((time.perf_counter() - t0) / iters)
    return sum(samples) / len(samples), state, samples


def bench_step(scene, warmup=3, iters=20, burst=10, neighbor_mode="resident",
               repeats=1, impl=None, **step_kw):
    """Times an on-device lax.scan burst of ``burst`` steps (one host
    dispatch). neighbor_mode 'resident' uses the grid-resident engine
    (ops.resident), with physics ``impl`` (default: the backend's own).
    ``repeats`` > 1 adds mean/sigma fields over that many timed
    repeats."""
    n = scene.settings.particle_count
    if neighbor_mode == "resident":
        from tpufluid.ops import resident

        run = resident.make_grid_multi_step(scene.settings, burst,
                                            impl=impl)
        state = resident.init_grid_state(scene.settings)
    else:
        from tpufluid import make_multi_step

        run = make_multi_step(scene.settings, burst,
                              neighbor_mode=neighbor_mode, **step_kw)
        state = scene.init()
    sec, _, samples = _timeit(run, state, scene.params, warmup=warmup,
                              iters=iters, repeats=repeats)
    sec /= burst
    out = dict(
        config=scene.name,
        particles=n,
        mode=neighbor_mode,
        ms_per_step=sec * 1e3,
        particle_steps_per_sec=n / sec,
    )
    if repeats > 1:
        rates = [n / (s / burst) for s in samples]
        mean = sum(rates) / len(rates)
        var = sum((r - mean) ** 2 for r in rates) / (len(rates) - 1)
        out["particle_steps_per_sec_samples"] = rates
        out["particle_steps_per_sec_sigma"] = var ** 0.5
    return out


def bench_render(scene, width=1920, height=1080, warmup=2, iters=5):
    import functools
    import jax
    from tpufluid.ops import render, render_binned

    step = scene.make_step(neighbor_mode="dense")
    state = scene.init()
    for _ in range(3):
        state = step(state, scene.params)
    cam = render.Camera(view_size=(
        scene.settings.size[0],
        scene.settings.size[0] * height / width,
    ))
    rfn = jax.jit(functools.partial(
        render_binned.render_metaball_binned, settings=scene.settings,
        width=width, height=height, camera=cam,
    ))
    frame = rfn(state)
    jax.block_until_ready(frame)
    t0 = time.perf_counter()
    for _ in range(iters):
        frame = rfn(state)
    jax.block_until_ready(frame)
    return (time.perf_counter() - t0) / iters * 1e3  # ms/frame


def bench_render_grid(scene, width=1920, height=1080, warmup=2, iters=5):
    """The resident-grid renderer (ops.render_grid): fluid surface
    straight off the slot grid — no to_particles sort, no re-binning."""
    import functools
    import jax
    from tpufluid.ops import render, render_grid, resident

    run10 = resident.make_grid_multi_step(scene.settings, 10)
    gs = resident.init_grid_state(scene.settings)
    gs = run10(gs, scene.params)
    cam = render.Camera(view_size=(
        scene.settings.size[0],
        scene.settings.size[0] * height / width,
    ))
    import dataclasses as _dc
    import jax.numpy as jnp
    from jax import lax

    burst = 10  # frames per dispatch

    @jax.jit
    def run(g):
        def body(c, _):
            g, prev = c
            # carry dependence (0-valued in f32) so XLA cannot hoist the
            # loop-invariant render out of the scan
            g = _dc.replace(g, pos_x=g.pos_x + prev[0, 0, 0] * 0.0)
            frame = render_grid.render_metaball_grid(
                g, scene.settings, width, height, cam)
            return (g, frame), None
        (g, frame), _ = lax.scan(body, (g, jnp.zeros((height, width, 4),
                                                     jnp.float32)),
                                 None, length=burst)
        return frame

    frame = run(gs)
    jax.block_until_ready(frame)
    t0 = time.perf_counter()
    for _ in range(iters):
        frame = run(gs)
    jax.block_until_ready(frame)
    return (time.perf_counter() - t0) / iters / burst * 1e3  # ms/frame


def bench_frame(scene, width=960, height=540, warmup=2, iters=5):
    """End-to-end ms/frame (step+render) at the reference's render size
    (renderer.rs:15 RENDER_DIMS 960x540) and offline cadence: 16 sim
    ticks per rendered frame (main.rs:199-201), one device dispatch."""
    import functools
    import jax
    from tpufluid.ops import render, render_grid, resident

    run16 = resident.make_grid_multi_step(scene.settings, 16)
    gs = resident.init_grid_state(scene.settings)
    gs = resident.make_grid_multi_step(scene.settings, 10)(gs, scene.params)
    cam = render.Camera(view_size=(
        scene.settings.size[0],
        scene.settings.size[0] * height / width,
    ))

    from jax import lax

    burst = 5  # frames per dispatch

    @jax.jit
    def frames(g):
        def body(g, _):
            g = run16(g, scene.params)
            rgba = render_grid.render_metaball_grid(
                g, scene.settings, width, height, cam)
            # full-frame output so XLA cannot dead-code the shading
            return g, rgba
        g, px = lax.scan(body, g, None, length=burst)
        return g, px

    gs, px = frames(gs)
    jax.block_until_ready(px)
    t0 = time.perf_counter()
    for _ in range(iters):
        gs, px = frames(gs)
    jax.block_until_ready(px)
    return ((time.perf_counter() - t0) / iters / burst
            * 1e3)  # ms (16 ticks + render)


def run_configs(which=None, out=sys.stdout, mode="resident"):
    """The scene ladder. which: config number 1-5 or None for all
    feasible on this host."""
    import jax
    from tpufluid import models

    results = {}

    def wants(i):
        return which is None or which == i

    def record(key, value):
        results[key] = value
        print(json.dumps({key: value}, default=float), file=out, flush=True)

    if wants(1):
        record("config1_4k", bench_step(models.dam_break_4k(),
                                        neighbor_mode=mode, burst=200))
    if wants(2):
        record("config2_64k", bench_step(models.scene_64k(),
                                         neighbor_mode=mode, burst=80))
    if wants(3):
        r = bench_step(models.scene_256k(), neighbor_mode=mode, burst=50)
        r["render_ms_per_frame_1080p"] = bench_render(models.scene_256k())
        r["render_grid_ms_per_frame_1080p"] = bench_render_grid(
            models.scene_256k())
        r["frame_ms_960x540_16ticks"] = bench_frame(models.scene_256k())
        record("config3_256k", r)
    if wants(4):
        r = bench_step(models.scene_1m(), neighbor_mode=mode, burst=120)
        r["render_grid_ms_per_frame_1080p"] = bench_render_grid(
            models.scene_1m())
        # batch: 8 independent 128k worlds (1M particles total) with
        # differing gravity/viscosity, stacked along the grid-row axis
        # (ops.resident n_worlds — no vmap, one kernel pass)
        import numpy as np
        from tpufluid import SimSettings
        from tpufluid.params import TickParams
        from tpufluid.ops import resident as res
        B = 8
        # per-world geometry mirrors scene_1m: a 512-column grid (no pad
        # columns), eighth-cell box offset, spawn 1008 columns -> rest
        # occupancy 4
        bsettings = SimSettings(
            particle_count=131072, particle_spacing=0.1,
            smoothing_radius=0.2, size=(101.95, 13.1), cell_capacity=8,
            spawn_columns=1008)
        plist = [
            TickParams.default(gravity=(0.0, -g), viscosity_coefficient=v)
            for g, v in zip(np.linspace(0.0, 2.0, B),
                            np.linspace(5.0, 40.0, B))
        ]
        bp = res.batched_params(plist)
        burst = 10
        brun = res.make_grid_multi_step(bsettings, burst, n_worlds=B)
        bgs = res.init_batched_grid_state(bsettings, B)
        sec, bgs_end, _ = _timeit(brun, bgs, bp, warmup=2, iters=5)
        sec /= burst
        r["batch8x128k_ms_per_step"] = sec * 1e3
        r["batch8x128k_particle_steps_per_sec"] = (
            B * bsettings.particle_count / sec)
        # per-world occupancy variance (kernel work ~ occupied rows x
        # occ3 per world) and the counted drops (the raw step counts
        # capacity losses instead of regrowing; FluidApp's grow policy is
        # the loss-free product path)
        r["batch8x128k_world_stats"] = res.batched_world_stats(
            bgs_end, bsettings, B)
        r["batch8x128k_lost"] = int(bgs_end.lost)
        record("config4_1m", r)
    if wants(5):
        if jax.device_count() >= 2:
            record("config5_sharded", bench_sharded())
        else:
            record("config5_sharded", dict(
                skipped=f"needs multi-device, have {jax.device_count()}"))

    return results


def bench_sharded(mode="resident", n=None, iters=10):
    """Config 5: multi-device throughput on whatever devices exist.

    mode 'resident' rides the row-band sharding
    (tpufluid.parallel.make_sharded_resident_step); 'dense' keeps the
    column-slab dense path for comparison.
    """
    import jax
    from tpufluid import SimSettings, TickParams

    import math
    d = jax.device_count()
    if n is None and d >= 8:
        from tpufluid import models
        settings = models.scene_4m().settings
        n = settings.particle_count
    else:
        if n is None:
            n = 524_288 * d
        side = round(204.3 * math.sqrt(n / 4_194_304), 1)
        settings = SimSettings(
            particle_count=n, particle_spacing=0.1, smoothing_radius=0.2,
            size=(side, side), cell_capacity=16,
        )
    params = TickParams.default()
    if mode == "resident":
        from tpufluid.parallel import (
            build_resident_spec, init_sharded_resident,
            make_sharded_resident_step)
        spec = build_resident_spec(settings, d)
        step = make_sharded_resident_step(spec)
        state = init_sharded_resident(spec)
    else:
        from tpufluid.parallel import (
            build_shard_spec, init_sharded, make_sharded_step)
        spec = build_shard_spec(settings, d)
        step = make_sharded_step(spec, neighbor_mode="dense")
        state = init_sharded(spec)

    def fn(st, p):
        new, _ = step(st, p)
        return new

    sec, _, _ = _timeit(fn, state, params, warmup=2, iters=iters)
    return dict(
        config=f"sharded-{d}dev-{mode}", particles=n, ms_per_step=sec * 1e3,
        particle_steps_per_sec=n / sec, devices=d,
    )


def run_parity(steps_short=10, steps_long=200, n=16384,
               out_path="PARITY.json"):
    """Engine parity on the real backend, every engine compiled.

    Short horizon: grid/dense trajectories allclose and resident
    nearest-neighbor-close to dense (SPH is chaotic — f32 reduction-order
    differences amplify exponentially, so tolerance parity is only
    meaningful over a short window; same criteria as tests/).
    Long horizon (skipped when ``steps_long`` is 0): per-engine
    invariants — mass conserved exactly, finite, in-bounds, kinetic
    energy within 10% across engines. Writes the report to ``out_path``
    unless it is None; returns the report.

    Scene: gravity -3 keeps peak cell occupancy bounded (~20 at K=32,
    measured with unbounded K=64). At -9.8 this box compacts without
    bound (rest_density 0 gives the EOS no density to defend, see
    params.suggest_cell_capacity) — that regime tests scene sizing, not
    engine parity.
    """
    import numpy as np
    import jax
    import jax.numpy as jnp
    from tpufluid import SimSettings, TickParams, init_state, make_multi_step
    from tpufluid.ops import resident

    s = SimSettings(particle_count=n, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(26.0, 26.0),
                    cell_capacity=32)
    params = TickParams.default(gravity=(0.0, -3.0))
    report = {"backend": jax.default_backend(), "n": n, "checks": {}}
    ok_all = True

    def check(name, cond, detail=""):
        nonlocal ok_all
        report["checks"][name] = {"ok": bool(cond), "detail": detail}
        ok_all = ok_all and bool(cond)

    # --- short horizon: trajectory parity
    outs = {}
    for mode in ("grid", "dense"):
        run = make_multi_step(s, steps_short, neighbor_mode=mode)
        outs[mode] = np.asarray(run(init_state(s), params).position)
    d = np.abs(np.sort(outs["grid"], 0) - np.sort(outs["dense"], 0)).max()
    check("grid_vs_dense_10step", d < 1e-4, f"max|dpos|={d:.2e}")

    rrun = resident.make_grid_multi_step(s, steps_short)
    gs = rrun(resident.init_grid_state(s), params)
    ps, live = resident.to_particles(gs, s)
    check("resident_mass_10step", int(live) == n and int(gs.lost) == 0,
          f"live={int(live)} lost={int(gs.lost)}")
    try:
        from scipy.spatial import cKDTree
        dd, _ = cKDTree(outs["dense"]).query(np.asarray(ps.position)[:n])
        check("resident_vs_dense_10step", dd.max() < 1e-3,
              f"max nn dist={dd.max():.2e}")
    except ImportError:
        pass

    # --- long horizon: invariants per engine
    energies = {}
    for mode in (("dense", "resident") if steps_long else ()):
        if mode == "resident":
            run = resident.make_grid_multi_step(s, steps_long)
            gs = run(resident.init_grid_state(s), params)
            st, live = resident.to_particles(gs, s)
            check(f"{mode}_mass_{steps_long}step",
                  int(live) == n and int(gs.lost) == 0,
                  f"live={int(live)} lost={int(gs.lost)}")
            pos = np.asarray(st.position)[:n]
            vel = np.asarray(st.velocity)[:n]
        else:
            run = make_multi_step(s, steps_long, neighbor_mode=mode)
            st = run(init_state(s), params)
            pos = np.asarray(st.position)
            vel = np.asarray(st.velocity)
        finite = np.all(np.isfinite(pos)) and np.all(np.isfinite(vel))
        inb = np.all(np.abs(pos) <= 13.0 + 1e-4)
        check(f"{mode}_sane_{steps_long}step", finite and inb,
              f"finite={finite} in_bounds={inb}")
        energies[mode] = float(0.5 * (vel ** 2).sum())
    if steps_long:
        rel = abs(energies["resident"] - energies["dense"]) / max(
            energies["dense"], 1e-9)
        check(f"energy_within_10pct_{steps_long}step", rel < 0.10,
              f"dense={energies['dense']:.4g} "
              f"resident={energies['resident']:.4g} rel={rel:.3f}")

    report["ok"] = ok_all
    report["generated_utc"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                            time.gmtime())
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    return report


def run_cross_backend_parity(steps=50, n=4096, out_path="PARITY.json"):
    """Step-for-step CPU-vs-GPU divergence of the SAME grid-mode step
    ("step-for-step trajectory agreement at fixed dt"; SURVEY section 4
    point 3).

    Per step, both backends get the IDENTICAL input state (synced: the
    GPU output becomes the next input for both), so the numbers below
    are single-step divergences — not compounded chaos. Records the
    max per-step |dpos|/|dvel| into PARITY.json under "cpu_vs_gpu" and
    whether the agreement is bitwise."""
    import numpy as np
    import jax
    from tpufluid import (SimSettings, TickParams, init_state, make_step)

    if jax.default_backend() == "cpu":
        print(json.dumps({"metric": "cpu_vs_gpu_step_parity",
                          "skipped": "no accelerator backend"}))
        return None
    s = SimSettings(particle_count=n, particle_spacing=0.1,
                    smoothing_radius=0.2, size=(16.0, 16.0),
                    cell_capacity=32)
    params = TickParams.default(gravity=(0.0, -3.0))
    step = make_step(s, neighbor_mode="grid")
    cpu = jax.devices("cpu")[0]
    acc = jax.devices()[0]
    state = init_state(s)
    max_dpos = 0.0
    max_dvel = 0.0
    max_drho = 0.0
    for i in range(steps):
        st_acc = step(jax.device_put(state, acc), params)
        st_cpu = step(jax.device_put(state, cpu), params)
        a_pos = np.asarray(st_acc.position)
        c_pos = np.asarray(st_cpu.position)
        max_dpos = max(max_dpos, float(np.abs(a_pos - c_pos).max()))
        max_dvel = max(max_dvel, float(np.abs(
            np.asarray(st_acc.velocity) - np.asarray(st_cpu.velocity)).max()))
        max_drho = max(max_drho, float(np.abs(
            np.asarray(st_acc.density) - np.asarray(st_cpu.density)).max()))
        state = st_acc  # synced inputs: continue from the GPU trajectory
    rec = dict(
        steps=steps, n=n,
        accelerator=jax.default_backend(),
        max_step_dpos=max_dpos, max_step_dvel=max_dvel,
        max_step_drho=max_drho,
        bitwise=(max_dpos == 0.0 and max_dvel == 0.0 and max_drho == 0.0),
        generated_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    )
    try:
        with open(out_path) as f:
            report = json.load(f)
    except (OSError, json.JSONDecodeError):
        report = {}
    report["cpu_vs_gpu"] = rec
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"metric": "cpu_vs_gpu_step_parity", **rec}))
    return rec


def device_info():
    """Platform, device kind and count as JAX reports them, and the
    card's name and power limit as nvidia-smi reports them (read in a
    child process that does not touch the card; "not available" when
    there is no nvidia-smi)."""
    import subprocess
    import jax

    dev = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "not available"
    return dict(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()), nvidia_smi=smi)


def physics_ab(repeats=3):
    """The resident step with its physics as the Triton kernels and as
    what XLA makes of the plain stages, alternated (triton, plain, plain,
    triton) so drift on the card shows. One JSON line per scene with
    ms/step of each run."""
    from tpufluid import models

    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(f"physics_ab needs a GPU, found {info}")
    out = []
    for scene, burst in ((models.scene_1m(), 20),
                         (models.dam_break_4k(), 100)):
        runs = []
        for impl in ("triton", "plain", "plain", "triton"):
            r = bench_step(scene, warmup=2, iters=5, burst=burst,
                           repeats=repeats, impl=impl)
            runs.append(dict(impl=impl, ms_per_step=r["ms_per_step"]))
        rec = dict(config=scene.name, burst=burst, runs=runs,
                   device=info["kind"], nvidia_smi=info["nvidia_smi"])
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true", help="full ladder to stderr")
    ap.add_argument("--parity", action="store_true",
                    help="compiled engine-parity report -> PARITY.json")
    ap.add_argument("--xparity", action="store_true",
                    help="step-for-step CPU-vs-GPU divergence -> PARITY.json")
    ap.add_argument("--physics-ab", action="store_true",
                    help="resident step: Triton kernels vs plain stages")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--neighbor-mode", default="resident",
                    choices=("grid", "dense", "resident"))
    args = ap.parse_args()
    configure_compile_cache()

    if args.parity:
        report = run_parity()
        print(json.dumps({"metric": "engine_parity",
                          "value": int(report["ok"]), "unit": "bool",
                          "backend": report["backend"]}))
        sys.exit(0 if report["ok"] else 1)

    if args.xparity:
        run_cross_backend_parity()
        return

    if args.physics_ab:
        physics_ab()
        return

    if args.all:
        run_configs(None, out=sys.stderr)

    from tpufluid import models
    r = bench_step(models.scene_1m(), warmup=3, iters=max(args.iters, 5),
                   burst=120, neighbor_mode=args.neighbor_mode, repeats=5)
    print(json.dumps(dict(
        metric="particle_steps_per_sec_1M",
        value=r["particle_steps_per_sec"],
        unit="particle-steps/s",
        sigma=r.get("particle_steps_per_sec_sigma"),
        samples=r.get("particle_steps_per_sec_samples"),
        device=device_info(),
    )))


if __name__ == "__main__":
    main()
