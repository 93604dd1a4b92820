"""Smoke test of tpufluid on one NVIDIA GPU, in one process.

    python chip_smoke.py                # one GPU: phases 1-4
    python chip_smoke.py --four-cards   # four GPUs: the sharded step only

Phases (any failure exits non-zero before the last line is printed):

1. device: JAX must find a GPU; prints its kind, the device count and the
   card's name and power limit (nvidia-smi).
2. kernels: compiles the resident step at the 1M scene's widths (prints
   its memory_analysis, checks that it holds the Triton kernels), compares
   each Triton kernel with the plain stage on real states, checks the
   resident engine against the dense engine at 16k and runs the 1M scene
   for 120 steps; compares the slot-grid renderer with the binned one.
3. main path: the CLI's run (resident and default engine, 100k) and
   render (960x540) commands, checked for mass, finiteness and the PNGs.
4. frame: times one 960x540 frame (16 ticks plus render) and the render
   field's share of it (informational, not a benchmark).

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

# limits of the kernel comparisons: sums over <= 9*K candidates taken in
# another order, in float32
DENSITY_LIMIT = 1e-5
STEP_LIMIT = 1e-4


class CheckFailed(RuntimeError):
    pass


def report(name, err, limit):
    """Print one comparison; raise when it is over its limit."""
    ok = bool(err <= limit)
    print(f"  {name}: err={err:.3e} limit={limit:.0e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise CheckFailed(f"{name}: {err:.3e} > {limit:.0e}")


def device_phase(count=None):
    """Phase 1: the device. Raises CheckFailed unless JAX's default
    device is a GPU (and, given ``count``, that many are present)."""
    import jax
    from bench import device_info

    info = device_info()
    print(f"device: platform={info['platform']} kind={info['kind']} "
          f"count={info['count']}", flush=True)
    if info["platform"] != "gpu":
        raise CheckFailed(f"no GPU: JAX's default device is "
                          f"{info['platform']} ({jax.devices()[0]})")
    if count is not None and info["count"] < count:
        raise CheckFailed(f"needs {count} GPUs, found {info['count']}")
    print(f"nvidia-smi: {info['nvidia_smi']}", flush=True)
    return dict(platform=info["platform"], kind=info["kind"],
                count=info["count"])


def compare_physics(gs, settings, params, tag):
    """Each Triton kernel against the plain stage on one resident state,
    relative to the largest value of each field over live slots."""
    import functools
    import jax
    import jax.numpy as jnp
    import numpy as np
    from tpufluid.ops import resident, slot_physics
    from tpufluid.ops.pallas import triton_resident

    live = np.asarray(gs.pos_x) < slot_physics.SENTINEL_HALF
    args = (gs.pos_x, gs.pos_y, gs.vel_x, gs.vel_y, gs.occ_row)
    dens_args = (params.mass, params.delta, params.pressure_constant,
                 params.rest_density)
    settings = resident.pad_capacity(settings)
    stages = {
        "triton": (triton_resident.density, triton_resident.forces_integrate),
        "plain": (slot_physics.density, slot_physics.forces_integrate),
    }
    dens = {name: jax.jit(functools.partial(d, settings=settings))(
        *args, *dens_args) for name, (d, _) in stages.items()}

    def rel(a, b):
        a, b = np.asarray(a)[live], np.asarray(b)[live]
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    report(f"{tag} density (1/inv_rho)",
           rel(1.0 / dens["triton"][1], 1.0 / dens["plain"][1]),
           DENSITY_LIMIT)
    report(f"{tag} pressure", rel(dens["triton"][0], dens["plain"][0]),
           DENSITY_LIMIT)
    pres, invr = dens["plain"]
    frame = gs.tick + jnp.uint32(1)
    new = {name: jax.jit(functools.partial(f, settings=settings))(
        *args[:4], pres, invr, gs.occ_row, params, frame=frame)
        for name, (_, f) in stages.items()}
    for i, field in enumerate(("pos_x", "pos_y", "vel_x", "vel_y")):
        report(f"{tag} step {field}",
               rel(new["triton"][i], new["plain"][i]), STEP_LIMIT)


def check_step_lowering(settings, params, gs):
    """Compile the resident step at real widths: print memory_analysis
    and check that the kernels are the compiled Triton ones."""
    from tpufluid.ops import resident

    if resident.physics_impl() != "triton":
        raise CheckFailed("resident engine did not pick the Triton kernels")
    step = resident.make_grid_step(settings)
    lowered = step.lower(gs, params)
    text = lowered.as_text()
    n_triton = text.count("__gpu$xla.gpu.triton")
    names = [n for n in ("sph_density_triton", "sph_forces_integrate_triton")
             if n in text]
    print(f"  lowered step: {n_triton} Triton custom calls, kernels {names}",
          flush=True)
    if n_triton < 2 or len(names) < 2:
        raise CheckFailed("the resident step does not hold both compiled "
                          "Triton kernels (interpreter or fallback?)")
    t0 = time.perf_counter()
    compiled = lowered.compile()
    print(f"  compile {time.perf_counter() - t0:.1f}s; memory_analysis: "
          f"{compiled.memory_analysis()}", flush=True)


def kernel_phase():
    """Phase 2: compiled kernels at real widths against the plain stages,
    the engine against the dense engine, the 1M run and the renderer."""
    import jax
    import numpy as np
    from tpufluid import models
    from tpufluid.ops import resident
    import bench

    scene = models.scene_1m()
    s, params = scene.settings, scene.params
    gs = resident.init_grid_state(s)
    check_step_lowering(s, params, gs)

    gs20 = resident.make_grid_multi_step(s, 20)(gs, params)
    compare_physics(gs20, s, params, "1M after 20 steps, K=8")
    compare_physics(resident.grow_capacity(gs20, 32),
                    dataclasses.replace(s, cell_capacity=32), params,
                    "1M after 20 steps, K=32")
    dam = models.dam_break_4k()
    gsd = resident.make_grid_multi_step(dam.settings, 150)(
        resident.init_grid_state(dam.settings), dam.params)
    occ = int(np.asarray(gsd.occ_row).max())
    compare_physics(gsd, dam.settings, dam.params,
                    f"4k dam-break after 150 steps, K=32, max occupancy {occ}")

    # resident against dense, 10-step horizon at 16k (bench.run_parity)
    rep = bench.run_parity(steps_short=10, steps_long=0, out_path=None)
    for name, c in rep["checks"].items():
        print(f"  parity {name}: {c['detail']} {'ok' if c['ok'] else 'FAIL'}",
              flush=True)
    if not rep["ok"] or "resident_vs_dense_10step" not in rep["checks"]:
        raise CheckFailed("resident vs dense parity failed")

    # 1M engine: 120 steps, finite, in bounds, mass exact
    t0 = time.perf_counter()
    gs120 = jax.block_until_ready(
        resident.make_grid_multi_step(s, 120)(gs, params))
    ps, live = resident.to_particles(gs120, s)
    pos = np.asarray(ps.position)
    vel = np.asarray(ps.velocity)
    half = np.asarray(s.size) * 0.5
    ok = (int(live) == s.particle_count and int(gs120.lost) == 0
          and np.isfinite(pos).all() and np.isfinite(vel).all()
          and (np.abs(pos) <= half + 1e-4).all())
    print(f"  1M 120 steps ({time.perf_counter() - t0:.1f}s incl. compile):"
          f" live={int(live)} lost={int(gs120.lost)} finite and in bounds="
          f"{ok}", flush=True)
    if not ok:
        raise CheckFailed("1M engine run failed its invariants")

    render_check(gs120, s)


def render_check(gs, settings, width=960, height=540):
    """render_grid's frame against render_binned on the same state, and
    against render_grid on the CPU, under the golden-image tolerance of
    tests/test_render_golden.py (mean abs diff < 1/255, under 1% of
    pixels off by more than 8/255). The CPU comparison catches a
    GPU-only error such as a resample in TF32."""
    import jax
    import numpy as np
    from tpufluid.ops import render, render_binned, render_grid, resident

    cam = render.Camera(view_size=(settings.size[0],
                                   settings.size[0] * height / width))
    grid = jax.jit(lambda g: render.to_rgba8(render_grid.render_metaball_grid(
        g, settings, width, height, cam)))
    gpu = np.asarray(grid(gs)).astype(np.int32)
    state, _ = resident.to_particles(gs, settings)
    others = {
        "render_binned": render.to_rgba8(render_binned.render_metaball_binned(
            state, settings, width, height, cam)),
        "render_grid on the CPU": grid(
            jax.device_put(gs, jax.devices("cpu")[0])),
    }
    for name, img in others.items():
        diff = np.abs(gpu - np.asarray(img).astype(np.int32))
        report(f"render_grid {width}x{height} vs {name}, mean abs diff "
               "(/255)", float(diff.mean()), 1.0)
        report(f"render_grid {width}x{height} vs {name}, share of pixels "
               "off by >8", float((diff.max(axis=-1) > 8).mean()), 0.01)


def main_path_phase(out_dir, particles=100_000, size=53, steps=600):
    """Phase 3: the CLI, in this process, on the reference's default
    scene (models.default_scene: 100k particles in a 53x53 box)."""
    import numpy as np
    from tpufluid import cli
    from tpufluid.utils import io as ioutils

    base = ["--particles", str(particles), "--size", str(size), str(size)]
    for name, extra in (("resident", ["--neighbor-mode", "resident"]),
                        ("default engine", [])):
        ck = os.path.join(out_dir, f"run_{len(extra)}.npz")
        argv = ["run", *base, *extra, "--steps", str(steps),
                "--checkpoint", ck]
        print(f"  cli {' '.join(argv)}", flush=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        out = buf.getvalue()
        print("    " + out.strip().replace("\n", "\n    "), flush=True)
        metrics = json.loads(out.split("metrics: ", 1)[1].splitlines()[0])
        state = ioutils.load_checkpoint(ck)
        pos = np.asarray(state.position)
        ok = (rc == 0 and pos.shape == (particles, 2)
              and np.isfinite(pos).all()
              and metrics.get("lost_particles", 0) == 0)
        print(f"    {name}: particles={pos.shape[0]} lost="
              f"{metrics.get('lost_particles', 0)} finite="
              f"{bool(np.isfinite(pos).all())} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise CheckFailed(f"cli run ({name}) failed")

    # the PNG encoder is the native library, built from native/ on first
    # use into a git-ignored path
    from tpufluid.native import pngio
    print(f"  native PNG encoder built and loaded: {pngio.available()}",
          flush=True)
    if not pngio.available():
        raise CheckFailed("the native library did not build")
    frames = os.path.join(out_dir, "frames")
    argv = ["render", *base, "--neighbor-mode", "resident", "--frames", "2",
            "--width", "960", "--height", "540", "--out", frames]
    print(f"  cli {' '.join(argv)}", flush=True)
    if cli.main(argv) != 0:
        raise CheckFailed("cli render failed")
    pngs = sorted(f for f in os.listdir(frames) if f.endswith(".png"))
    img = ioutils.read_png(os.path.join(frames, pngs[-1])) if pngs else None
    ok = len(pngs) == 2 and img is not None and img.shape == (540, 960, 4)
    print(f"    wrote {pngs}, last {None if img is None else img.shape} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise CheckFailed("cli render wrote no 960x540 PNGs")


def frame_phase(info):
    """Phase 4: one 960x540 frame of the reference's default scene
    (16 ticks plus render) and the render field's share of it."""
    import jax
    import jax.numpy as jnp
    from tpufluid import models
    from tpufluid.ops import render, render_grid, resident

    scene = models.default_scene()
    s, params = scene.settings, scene.params
    width, height = 960, 540
    cam = render.Camera(view_size=(s.size[0], s.size[0] * height / width))
    run16 = resident.make_grid_multi_step(s, 16)
    gs = resident.make_grid_multi_step(s, 64)(
        resident.init_grid_state(s), params)
    frame = jax.jit(lambda g: render_grid.render_metaball_grid(
        g, s, width, height, cam))
    field = jax.jit(lambda g: render_grid.coarse_metaball_fields(
        g.pos_x, g.pos_y, jnp.sqrt(g.vel_x * g.vel_x + g.vel_y * g.vel_y),
        g.occ_row, s))

    def timed(fn, n=10):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / n * 1e3

    ticks = timed(lambda: run16(gs, params))
    render_ms = timed(lambda: frame(gs))
    field_ms = timed(lambda: field(gs))
    total = ticks + render_ms
    print(f"  frame 960x540 ({scene.name}, {info['nvidia_smi']}): 16 ticks "
          f"{ticks:.3f} ms + render {render_ms:.3f} ms = {total:.3f} ms; "
          f"render field {field_ms:.3f} ms = {field_ms / total:.1%} of the "
          "frame", flush=True)


def four_card_phase():
    """--four-cards: the row-band sharded resident step on a 4-GPU mesh
    against the single-GPU resident step, scene_4m, 10 steps."""
    import jax
    import numpy as np
    from tpufluid import models
    from tpufluid.ops import resident
    from tpufluid.parallel import (build_resident_spec, comm_audit,
                                   gather_resident, init_sharded_resident,
                                   make_resident_mesh,
                                   make_sharded_resident_step)

    scene = models.scene_4m()
    s, params = scene.settings, scene.params
    spec = build_resident_spec(s, 4)
    mesh = make_resident_mesh(spec)
    step = make_sharded_resident_step(spec, mesh=mesh)
    gs = init_sharded_resident(spec, mesh)
    ops = comm_audit.audit_step(step, gs, params)
    print(f"  collectives in one step: {ops['ppermute_bytes_per_dir']} B/dir"
          f" ppermute, {ops['all_gather_bytes_conditional']} B conditional "
          f"all_gather, {ops['psum_scalars']} psum; "
          + ", ".join(f"{o.primitive}{o.shape}" for o in ops["ops"]),
          flush=True)
    t0 = time.perf_counter()
    for _ in range(10):
        gs, stats = step(gs, params)
    jax.block_until_ready(gs)
    t_shard = time.perf_counter() - t0
    got, live = gather_resident(gs, spec)
    print(f"  sharded 10 steps ({t_shard:.1f}s incl. compile): live="
          f"{int(live)} lost={int(gs.lost)} per device "
          f"{np.asarray(stats['n_valid']).tolist()}", flush=True)

    ref = resident.init_grid_state(s)
    run = resident.make_grid_multi_step(s, 10)
    ref = jax.device_put(ref, jax.devices()[0])
    ref = run(ref, params)
    want, live_ref = resident.to_particles(ref, s)

    # steady-state step times after the comparison (informational)
    def per_step(fn, g, n=20):
        g = jax.block_until_ready(fn(g))
        t0 = time.perf_counter()
        for _ in range(n):
            g = fn(g)
        jax.block_until_ready(g)
        return (time.perf_counter() - t0) / n * 1e3

    one = resident.make_grid_step(s)
    t4 = per_step(lambda g: step(g, params)[0], gs)
    t1 = per_step(lambda g: one(g, params), ref)
    print(f"  ms/step: 4 cards {t4:.3f}, 1 card {t1:.3f}", flush=True)
    n = s.particle_count
    if int(live) != n or int(live_ref) != n or int(gs.lost) or int(ref.lost):
        raise CheckFailed(f"mass: sharded live {int(live)}, single "
                          f"{int(live_ref)}, of {n}")
    from scipy.spatial import cKDTree
    d, _ = cKDTree(np.asarray(want.position)[:n]).query(
        np.asarray(got.position)[:n])
    report("4 cards vs 1 card, 10 steps, largest nearest-neighbour "
           "distance", float(d.max()), 1e-3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded step and its reference")
    args = ap.parse_args(argv)

    from tpufluid.utils.cache import configure_compile_cache
    configure_compile_cache()
    import bench

    t0 = time.perf_counter()
    if args.four_cards:
        device = device_phase(count=4)
        print("phase 5: four cards", flush=True)
        four_card_phase()
    else:
        device = device_phase()
        print("phase 2: kernels at real widths", flush=True)
        kernel_phase()
        print("phase 3: main path through the CLI", flush=True)
        with tempfile.TemporaryDirectory() as out_dir:
            main_path_phase(out_dir)
        print("phase 4: frame", flush=True)
        frame_phase(bench.device_info())
    print(f"all phases passed in {time.perf_counter() - t0:.1f}s",
          flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
