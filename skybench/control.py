"""The check's control, its planted faults, and the readings its limits
are set from.

    python3 -m skybench.control --workload <cell> --seeds 1,2,3 [--seconds 6]
        [--as control|program|fault:<Fault>|fault:<CutFault>] [--dtype bfloat16|float32]

prints one JSON line a seed with the numbers the cell's check compares:

- `control`: the plain reference, computed in `--dtype` (bfloat16 by
  default: the precision below the float32 the configuration states), put
  in the program's place and judged as the program's outputs are. The
  program has no bfloat16 computation of its own (its bfloat16 noise
  textures are computed on in float32). With `--dtype float32` the same
  reading is the float32 reference's own distance from the float64 one:
  the floor under what a float32 program can read.
- `program`: the cell's timed path, once a seed in one process (set-up, a
  window of --seconds, the check), as the benchmark runs it.
- `fault:<Fault>`: the same with the timed path broken underneath by one
  of the faults below; `fault:<CutFault>` by one of `CUT_FAULTS`, which
  only a cell whose mix cuts the scene can show.

The benchmark's own runs never run this module. A hook object is how the
faults reach into a run: the engine once built, and each tick's frame or
each call's map as it is produced.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


class Hooks:
    """No change to the run: each method hands back what it is given."""

    def on_engine(self, eng) -> None:
        pass

    def after_tick(self, eng, frame):
        return frame

    def after_cycle(self, eng, out):
        return out


def _half_mean(t):
    """t with its first half of rows set to the mean of the other half."""
    half = t.shape[0] // 2
    t[:half] = t[half:].mean(dim=(0, 1))
    return t


class Unchanged(Hooks):
    """A step that returns its state unchanged: a serving tick writes no
    tile (the maps keep what the warm start drew); a cycle hands back the
    map of the call before."""

    def __init__(self):
        self.prev = None

    def on_engine(self, eng):
        eng._write_tile = lambda: None

    def after_cycle(self, eng, out):
        prev, self.prev = self.prev, out.clone()
        return torch.zeros_like(out) if prev is None else prev


class HalfMean(Hooks):
    """Half of the batch left out, the mean taken over the rest: half of
    each written tile's rows (of each call's map) replaced by the mean of
    the other half."""

    def after_tick(self, eng, frame):
        f = eng.ring.frame - 1
        region = eng.perf.update_region_size
        per_row = eng.perf.texture_size // region
        x0, y0 = (f % per_row) * region, (f // per_row) * region
        _half_mean(eng.cloud_ring[eng.ring.texture_to_update, y0:y0 + region, x0:x0 + region])
        return frame

    def after_cycle(self, eng, out):
        return _half_mean(out)


class Altered(Hooks):
    """An answer altered where it is produced: each displayed frame (each
    call's map) rolled by half its width, as if made for another view."""

    def after_tick(self, eng, frame):
        return torch.roll(frame, frame.shape[1] // 2, dims=1)

    def after_cycle(self, eng, out):
        return torch.roll(out, out.shape[1] // 2, dims=1)


class StaleCut(Hooks):
    """A scene cut that leaves tiles of the old scene on show, the
    program's own fault at a cut mid-cycle, made to happen at any cut:
    after each tick that asked for a full sky init, the first half of the
    displayed `from` map's tiles (in the engine's tile order) written back
    as they stood before the cut."""

    def __init__(self):
        self.before = None

    def on_engine(self, eng):
        request = eng.request_full_sky_init

        def keep_and_request():
            self.before = eng.cloud_ring.clone()
            request()

        eng.request_full_sky_init = keep_and_request

    def after_tick(self, eng, frame):
        if self.before is not None:
            region = eng.perf.update_region_size
            per_row = eng.perf.texture_size // region
            slot = eng.ring.texture_to_blend_from
            for t in range(eng.perf.frames_to_update // 2):
                y0, x0 = (t // per_row) * region, (t % per_row) * region
                tile = (slot, slice(y0, y0 + region), slice(x0, x0 + region))
                eng.cloud_ring[tile] = self.before[tile]
            self.before = None
        return frame


FAULTS = {f.__name__: f for f in (Unchanged, HalfMean, Altered)}
# Faults that a cell whose mix cuts the scene can have, and no other cell.
CUT_FAULTS = {f.__name__: f for f in (StaleCut,)}


def readings(workload: str, seeds, seconds: float = 6.0, hooks=None, device="cuda",
             root=None) -> list:
    """[{seed, checks, metrics}]: one run of the timed path a seed."""
    from skybench import run

    kw = {} if root is None else {"root": root}
    rows = []
    for seed in seeds:
        line = run.measure(workload, seed, seconds, False, device=device, hooks=hooks, **kw)
        rows.append({"seed": seed, "checks": {k: v["value"] for k, v in line["checks"].items()},
                     "metrics": {k: v["value"] for k, v in line["metrics"].items()}})
    return rows


def control_readings(workload: str, seeds, dtype=torch.bfloat16, device="cuda",
                     root=None) -> list:
    """[{seed, checks}]: the reference in `dtype` in the program's place."""
    from skybench import run

    kw = {} if root is None else {"root": root}
    r = run.resolve(run.load_benchmark(**kw), workload, **kw)
    return [{"seed": seed,
             "checks": {name: value for name, value, _ in
                        r["kind"].control(r["config"], r["traffic"], seed,
                                          torch.device(device), dtype)}}
            for seed in seeds]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=6.0)
    faults = {**FAULTS, **CUT_FAULTS}
    ap.add_argument("--as", dest="what", default="control",
                    help="control, program or fault:<" + "|".join(faults) + ">")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("skybench.control: no CUDA card", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.what == "control":
        rows = control_readings(args.workload, seeds, getattr(torch, args.dtype))
    elif args.what == "program":
        rows = readings(args.workload, seeds, args.seconds)
    elif args.what.startswith("fault:") and args.what[6:] in faults:
        rows = [dict(row, fault=args.what[6:]) for seed in seeds
                for row in readings(args.workload, [seed], args.seconds,
                                    hooks=faults[args.what[6:]]())]
    else:
        ap.error(f"--as {args.what}: not control, program or fault:<name>")
    for row in rows:
        print(json.dumps(dict(row, workload=args.workload, run=args.what,
                              dtype=args.dtype if args.what == "control" else None)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
