"""Command-line simulation driver.

Replacement for the reference's build-and-run harness
(Makefile `make run`, reference run/Makefile:38-48): where the reference
bakes all parameters into src/pic1dp_input.F90 at compile time, here a run
is a preset name or a JSON config (Config.to_json / from_json) plus
overrides, executed immediately.

    python -m pic1dp_tpu.run                          # default bump-on-tail
    python -m pic1dp_tpu.run -p landau -o run1        # preset, output dir
    python -m pic1dp_tpu.run -c my_config.json        # full config file
    python -m pic1dp_tpu.run -s time_max=50 -s nx=256 # overrides
    python -m pic1dp_tpu.run --write-config cfg.json  # dump config and exit
    python -m pic1dp_tpu.run --resume ckpt.npz        # resume a checkpoint
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import sys

from pic1dp_tpu import config as config_mod


_PRESETS = {
    "bump_on_tail": config_mod.bump_on_tail_default,
    "landau": config_mod.landau_damping,
    "two_stream": config_mod.two_stream,
}


def _apply_overrides(cfg, overrides: list[str]):
    fields = {f.name for f in dataclasses.fields(cfg)}
    kv = {}
    for item in overrides:
        key, _, raw = item.partition("=")
        if key not in fields:
            raise SystemExit(f"unknown config field {key!r}; valid: "
                             f"{', '.join(sorted(fields))}")
        try:
            kv[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            kv[key] = raw  # plain string (e.g. equilibrium name)
    return config_mod.Config.from_dict({**cfg.to_dict(), **kv})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run a pic1dp_tpu simulation")
    ap.add_argument("-p", "--preset", choices=sorted(_PRESETS),
                    default="bump_on_tail")
    ap.add_argument("-c", "--config", metavar="<json file>",
                    help="load full config from JSON (overrides preset)")
    ap.add_argument("-s", "--set", metavar="field=value", action="append",
                    default=[], help="override a config field")
    ap.add_argument("-o", "--out", metavar="<dir>", default=".",
                    help="output directory for pic1dp.out (default .)")
    ap.add_argument("--no-output", action="store_true",
                    help="run without writing the science-data stream")
    ap.add_argument("--write-config", metavar="<json file>",
                    help="write the resolved config and exit")
    ap.add_argument("--checkpoint-interval", type=float, default=None,
                    metavar="<sim time>",
                    help="write a checkpoint every so much simulation time")
    ap.add_argument("--resume", metavar="<checkpoint.npz>",
                    help="resume from a checkpoint written by a previous run")
    ap.add_argument("--mesh", metavar="<n devices>", type=int, default=None,
                    help="shard the particle axis over an n-device mesh "
                    "(default: all devices if more than one)")
    ap.add_argument("--distributed", action="store_true",
                    help="initialize the multi-process JAX runtime first, "
                    "from JAX's cluster detection (parallel/launch.py)")
    ap.add_argument("--profile", metavar="<trace dir>", default=None,
                    help="capture a jax.profiler trace of the run")
    ap.add_argument("--phase-table", action="store_true",
                    help="after the run, print the instrumented per-phase "
                    "step decomposition (reference wtimer granularity; "
                    "costs extra compiles)")
    ap.add_argument("--emulate-ranks", type=int, default=1, metavar="<npe>",
                    help="with -s rng='{\"backend\": \"multirand\"}': load "
                    "markers in the draw order of an npe-rank reference run")
    args = ap.parse_args(argv)

    if args.config:
        with open(args.config) as fh:
            cfg = config_mod.Config.from_json(fh.read())
    else:
        cfg = _PRESETS[args.preset]()
    if args.set:
        cfg = _apply_overrides(cfg, args.set)
    cfg = cfg.validate()

    if args.write_config:
        with open(args.write_config, "w") as fh:
            fh.write(cfg.to_json())
        print(f"config written to {args.write_config}")
        return 0

    import jax

    from pic1dp_tpu.core.simulation import Simulation

    if args.distributed:
        from pic1dp_tpu.parallel import launch

        launch.initialize()
    mesh = args.mesh
    if mesh is None and jax.device_count() > 1:
        mesh = jax.device_count()

    sim = Simulation(cfg, out_path=None if args.no_output else args.out,
                     checkpoint_interval=args.checkpoint_interval,
                     checkpoint_path=None if args.no_output else args.out,
                     mesh=mesh, emulate_ranks=args.emulate_ranks)
    if args.resume:
        sim.restore_checkpoint(args.resume)
    if args.profile:
        with jax.profiler.trace(args.profile):
            sim.run()
        print(f"profiler trace written to {args.profile}")
    else:
        sim.run()
    if args.phase_table:
        print(sim.phase_table(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
