"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m skybench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `skybench/` and
the program (`cloudscape_tpu_torch`), on a machine with a CUDA card.

Everything is found by name: the cell's entry in `BENCHMARK.json` names
its configuration (`skybench/configs/<config>.json`) and its traffic mix
(`skybench/traffic/<traffic>.json`, whose `kind` names the module
`skybench/kinds/<kind>.py` that drives it); the limits of its check are
`skybench/limits/<cell>.json`; each per-layer metric is read by
`skybench/metrics/<metric>.py`. With --trace 0 the line holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, the device's
busy and traced seconds and a breakdown of the trace. Either way the
outputs are checked against the plain reference once the window has
closed; each number compared is printed beside its limit, last on
standard error and last in the line.

Exit codes: 0 with a result; 2 without a CUDA card (or fewer cards than
the cell asks for); 3 when the JAX package or JAX is loaded after the
window. Set-up (`setup_s`) runs from the process's start to the first
timed call.
"""

from __future__ import annotations

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_AT_IMPORT = _process_age_s()
_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from skybench import traffic  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Top-level module names that must not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "cloudscape_tpu")


def load_benchmark(root: str = ROOT) -> dict:
    """BENCHMARK.json at the root of the checkout."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(bench: dict, workload: str, root: str = ROOT) -> dict:
    """The cell, its configuration (with the cell's `limits`), traffic
    mix, kind module, end-to-end metric names and per-layer metric
    entries, all found by name."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "skybench", "limits", workload + ".json")) as f:
        cfg["limits"] = json.load(f)
    mix = traffic.load(cell["traffic"], os.path.join(root, "skybench", "traffic"))
    e2e = [m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in e2e else [])]
    return {"cell": cell, "config": cfg, "traffic": mix, "end_to_end": e2e,
            "per_layer": layer, "kind": importlib.import_module(f"skybench.kinds.{mix['kind']}")}


def reader(name: str, root: str = ROOT):
    """The `read(layer)` function of skybench/metrics/<name>.py."""
    path = os.path.join(root, "skybench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"skybench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def measure(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
            root: str = ROOT, hooks=None, age_at_start: float = 0.0,
            t_start: float | None = None) -> dict:
    """One run of the cell: the result line's fields, before printing.
    t_start / age_at_start: the perf_counter reading from which set-up is
    counted and the process's age then."""
    t_start = time.perf_counter() if t_start is None else t_start
    r = resolve(load_benchmark(root), workload, root)
    out = r["kind"].run(r["config"], r["traffic"], seed, seconds, trace, device, hooks=hooks)
    setup_s = age_at_start + (out["setup_done"] - t_start)
    checks = {name: {"value": value, "limit": limit} for name, value, limit in out["checks"]}
    failed = sum(1 for c in checks.values() if not c["value"] >= c["limit"])
    units = {m["name"]: m["unit"] for m in load_benchmark(root)["end_to_end"]}
    if trace:
        metrics = {}
        for m in r["per_layer"]:
            value = reader(m["name"], root)(out.get("layer", {}))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        metrics = {name: {"value": values[name], "unit": units[name]}
                   for name in r["end_to_end"]}
    import torch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(dev) if on_card else "cpu", "count": 1,
                  "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace and "busy_s" in out:
        device_rec["busy_s"], device_rec["window_s"] = out["busy_s"], out["window_s"]
    line = {"correct": failed == 0, "attempted": out["attempted"], "failed": failed,
            "metrics": metrics, "device": device_rec}
    if trace and "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = resolve(load_benchmark(), args.workload)["cell"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"skybench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    line = measure(args.workload, args.seed, args.seconds, bool(args.trace),
                   age_at_start=_AGE_AT_IMPORT, t_start=_T_IMPORT)
    found = forbidden_modules()
    if found:
        print(f"skybench: the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r}, higher passes)",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
