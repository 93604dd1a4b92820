"""CLI driver: ``python -m tpufluid <run|render|bench|info>``.

The reference's config story is hardcoded consts + egui sliders (SURVEY.md
section 5 "Config"); here every SimSettings/TickParams field is a flag.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_common(p):
    p.add_argument("--particles", type=int, default=100_000)
    p.add_argument("--spacing", type=float, default=0.1)
    p.add_argument("--radius", type=float, default=0.2,
                   help="smoothing radius h")
    p.add_argument("--size", type=float, nargs=2, default=(53.0, 53.0))
    p.add_argument("--cell-capacity", type=int, default=16)
    p.add_argument("--capacity-policy",
                   choices=("grow", "strict", "fixed"), default="grow",
                   help="bounded-engine capacity handling: grow = "
                        "auto-size + regrow-and-replay, never loses mass "
                        "(default); strict = refuse undersized scenes; "
                        "fixed = keep the given capacity, count losses")
    p.add_argument("--no-strict-capacity", action="store_true",
                   help="deprecated alias for --capacity-policy fixed")
    p.add_argument("--texture-size", type=int, nargs=2, default=(1024, 1024),
                   help="obstacle force-field resolution (W H)")
    p.add_argument("--dt", type=float, default=1.0 / 120.0)
    p.add_argument("--gravity", type=float, nargs=2, default=(0.0, 0.0))
    p.add_argument("--mass", type=float, default=1.0)
    p.add_argument("--pressure", type=float, default=50.0)
    p.add_argument("--rest-density", type=float, default=0.0)
    p.add_argument("--damping", type=float, default=0.1)
    p.add_argument("--viscosity", type=float, default=25.0)
    p.add_argument("--surface-tension", action="store_true")
    p.add_argument("--neighbor-mode",
                   choices=("resident", "grid", "dense", "naive"),
                   default="dense",
                   help="engine: resident = grid-resident (Triton kernels "
                        "on a GPU; obstacles at cell granularity), dense = "
                        "slot-grid rolls, grid = windowed, naive = "
                        "all-pairs oracle")
    p.add_argument("--x-boundary", choices=("bounce", "wrap"),
                   default="bounce")
    p.add_argument("--adaptive-subsampling", action="store_true",
                   help="stride pressure neighbors 1/5/13 at density "
                        "150/200 (supported by every engine)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="resume from / save to this .npz")
    p.add_argument("--circle", type=float, nargs=3, action="append",
                   default=[], metavar=("X", "Y", "R"),
                   help="add a circle obstacle (repeatable)")
    p.add_argument("--rect", type=float, nargs=5, action="append",
                   default=[], metavar=("X", "Y", "W", "H", "ROT"),
                   help="add a rotated rect obstacle (repeatable)")
    p.add_argument("--video-field", type=str, default=None,
                   help="grayscale frames (.npy/.npz or any ffmpeg input) "
                        "driving the obstacle force field; dark = obstacle")


def _build_app(args):
    from .app import FluidApp
    from .params import SimSettings, TickParams
    from .ops import forcefield as ff

    settings = SimSettings(
        particle_count=args.particles, particle_spacing=args.spacing,
        smoothing_radius=args.radius, size=tuple(args.size),
        cell_capacity=args.cell_capacity,
        texture_size=tuple(args.texture_size),
    )
    params = TickParams.default(
        delta=args.dt, gravity=tuple(args.gravity), mass=args.mass,
        pressure_constant=args.pressure, rest_density=args.rest_density,
        damping_factor=args.damping, viscosity_coefficient=args.viscosity,
    )
    objs = [("circle", (x, y), r) for x, y, r in args.circle]
    objs += [("rect", (x, y), (w, h), rot) for x, y, w, h, rot in args.rect]
    objects = ff.Objects.from_list(objs) if objs else None
    mode = args.neighbor_mode
    policy = "fixed" if args.no_strict_capacity else args.capacity_policy
    app = FluidApp(settings, params, objects,
                   capacity_policy=policy,
                   surface_tension=args.surface_tension,
                   adaptive_subsampling=args.adaptive_subsampling,
                   neighbor_mode=mode, x_boundary=args.x_boundary)
    if args.video_field:
        from .utils import io as ioutils
        app.set_video_field(ioutils.load_gray_frames(args.video_field))
    if args.checkpoint:
        import os
        if os.path.exists(args.checkpoint):
            app.load(args.checkpoint)
    return app


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tpufluid")
    sub = parser.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="advance the simulation N steps")
    _add_common(run_p)
    run_p.add_argument("--steps", type=int, default=1200)
    run_p.add_argument("--report-every", type=int, default=120)

    render_p = sub.add_parser("render", help="offline render mode")
    _add_common(render_p)
    render_p.add_argument("--frames", type=int, default=60)
    render_p.add_argument("--out", type=str, default=None,
                          help="PNG output dir (default 'output'; omitted "
                               "when --mp4 is given: frames stream straight "
                               "to the encoder, no PNG intermediates)")
    render_p.add_argument("--width", type=int, default=960)
    render_p.add_argument("--height", type=int, default=540)
    render_p.add_argument("--mode", choices=("metaball", "particles"),
                          default="metaball")
    render_p.add_argument("--mp4", type=str, default=None,
                          help="additionally encode the frames to this "
                               "mp4 (needs an ffmpeg binary)")
    render_p.add_argument("--fps", type=int, default=30)

    sub.add_parser("info", help="print device/platform info")

    bench_p = sub.add_parser("bench", help="run the benchmark ladder")
    bench_p.add_argument("--config", type=int, default=None,
                         help="scene config number (1-5); default: all")

    args = parser.parse_args(argv)
    from .utils.cache import configure_compile_cache
    configure_compile_cache()

    if args.cmd == "info":
        import jax
        print(json.dumps(dict(
            backend=jax.default_backend(),
            devices=[str(d) for d in jax.devices()],
            device_count=jax.device_count(),
        ), indent=2))
        return 0

    if args.cmd == "bench":
        import os
        import sys as _sys
        _sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        from bench import run_configs  # repo-root bench harness
        run_configs(args.config)
        return 0

    app = _build_app(args)

    if args.cmd == "run":
        app.sim_state = app.sim_state.RUNNING
        t0 = time.perf_counter()
        done = 0
        while done < args.steps:
            chunk = min(args.report_every, args.steps - done)
            app.run(chunk)  # scan bursts: one dispatch per <=64 ticks
            done += chunk
            if app.timer.last_rate:
                rate = app.timer.last_rate
                print(f"step {done}/{args.steps}  "
                      f"{rate:.1f} steps/s  "
                      f"{rate * app.settings.particle_count:.3e} particle-steps/s")
        import jax
        jax.block_until_ready(app.state.position)
        dt = time.perf_counter() - t0
        print(f"done: {args.steps} steps in {dt:.2f}s "
              f"({args.steps / dt:.1f} steps/s)")
        print("metrics: " + json.dumps(app.metrics(), default=float))
        if args.checkpoint:
            app.save(args.checkpoint)
            print(f"checkpoint -> {args.checkpoint}")
        return 0

    if args.cmd == "render":
        t0 = time.perf_counter()

        def progress(i):
            elapsed = time.perf_counter() - t0
            eta = elapsed / (i + 1) * (args.frames - i - 1)
            print(f"saved frame {i+1}/{args.frames}, elapsed {elapsed:.1f}s, "
                  f"eta {eta:.1f}s")

        if args.mp4 and args.out is None:
            # PNG-free path: frames stream straight into the encoder
            app.render_mp4(args.mp4, args.frames, args.width, args.height,
                           mode=args.mode, fps=args.fps, progress=progress)
            print(f"encoded {args.mp4}")
        else:
            out = args.out or "output"
            paths = app.render_sequence(
                out, args.frames, args.width, args.height,
                mode=args.mode, progress=progress,
            )
            print(f"wrote {len(paths)} frames to {out}/")
            if args.mp4:
                from .utils import io as ioutils
                ioutils.save_mp4(
                    args.mp4, (ioutils.read_png(p) for p in paths),
                    fps=args.fps)
                print(f"encoded {args.mp4}")
        if args.checkpoint:
            app.save(args.checkpoint)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
