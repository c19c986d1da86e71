"""The benchmark of ``pathtracerap_tpu_torch`` on NVIDIA GPUs.

    python3 -m ptbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix (:mod:`ptbench.spec`).  Set-up
builds the scene from the configuration, hands it to the program and runs
the cell's set-up frames or steps; ``setup_s`` runs from process start to
the first timed unit.  With ``--trace 0`` a closed loop of frames or steps
runs for ``--seconds`` and the cell's end-to-end metrics are printed; with
``--trace 1`` ``trace_units`` of them run under ``torch.profiler`` and the
per-layer metrics (``ptbench/metrics/<name>.py``) are read from the trace
and from the reference's work counts.  Either way the outputs are then
checked against the plain reference (:mod:`ptbench.reference`).

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
traced, and ``checks``: each number compared with its limit); the last
lines of standard error repeat the checks.  Without the CUDA devices the
cell asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One process, few threads: the host enqueues the work, and pools of
# worker threads only compete with it for the machine's cores.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

JAX_NAMES = ("jax", "jaxlib", "flax", "pathtracerap_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that the run must not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(JAX_NAMES))


def percentile(values, pct: int) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[pct - 1]


def power_limit_w():
    """The card's power limit in watts, from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nonfinite(out):
    """Whether a frame, or a train step's loss, holds a non-finite value."""
    import torch

    return (~torch.isfinite(out[0] if isinstance(out, tuple) else out)).any()


def timed_window(cell, seconds: float, device):
    """The closed loop: frames or steps back to back until ``seconds`` have
    passed.  Returns (each unit's seconds, the window's seconds, the count
    of non-finite outputs as a device tensor, the window's start)."""
    import torch

    times, i = [], cell.first_unit
    bad = torch.zeros((), dtype=torch.int64, device=device)
    bad += _nonfinite(torch.zeros((2, 2, 3), device=device).clone())  # load these kernels now
    _sync(device)
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        out = cell.unit(i)
        _sync(device)
        b = time.perf_counter()
        times.append(b - a)
        cell.keep(i, out)
        bad += _nonfinite(out)
        i += 1
        if b - t0 >= seconds:
            return times, b - t0, bad, t0


def traced_window(cell, units: int, device):
    """``units`` frames or steps under the profiler, each in a
    ``ptbench.unit`` span inside one ``ptbench.window`` span.  Returns
    (outputs [(i, out)], copied for the check, the profiler, start)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ptbench import cells, devtrace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    outs = []
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW):
            for i in range(cell.first_unit, cell.first_unit + units):
                with record_function(devtrace.UNIT):
                    out = cell.unit(i)
                    _sync(device)
                outs.append((i, cells.cloned(out)))
    return outs, prof, t0


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device, chips: int = 1,
             t_start: float = T_START, root: str = None) -> dict:
    """One run of the cell ``c`` (:func:`ptbench.spec.cell`) on ``device``:
    set-up, the window, the check.  Returns the result object.  ``root``
    is the checkout that holds the configurations' meshes and the metrics'
    readers."""
    import torch

    from ptbench import cells, devtrace, roofline, spec

    root = root or spec.ROOT
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic = c["traffic"]
    cell = cells.make_cell(c["config"], traffic, seed, device, root=root)
    cell.setup()
    _sync(device)
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if trace:
        outs, prof, t0 = traced_window(cell, traffic["trace_units"], device)
        bad = sum(int(_nonfinite(o)) for _, o in outs)
        attempted = len(outs)
        cell.kept = outs
    else:
        times, window_s, bad, t0 = timed_window(cell, seconds, device)
        bad = int(bad)
        attempted = len(times)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    units = [i for i, _ in outs] if trace else []
    numbers, counts = cell.check(units, roofline.COUNT_EVERY if trace else 0)
    limits = cell.limits
    ok = bool(numbers) and set(numbers) <= set(limits) and all(
        math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    result.update(correct=ok and bad == 0, attempted=attempted, failed=bad)

    if trace:
        tr = devtrace.from_profiler(prof)
        ctx = types.SimpleNamespace(trace=tr, units=attempted, kind=traffic["kind"],
                                    counts=roofline.total(counts) if counts else None,
                                    n_triangles=cell.inputs.num_triangles)
        for m in c["per_layer"]:
            value = spec.reader(m["name"], root).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {
            traffic["rate"]: attempted * cell.work / window_s / 1e6,
            traffic["tail"]: percentile(times, traffic["tail_pct"]) * 1e3,
            "setup_s": t0 - t_start,
        }
        for m in c["end_to_end"]:
            if m["name"] in e2e:
                result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    if trace:
        dev["busy_s"] = devtrace.busy_s(tr)
        dev["window_s"] = tr.window_s
        result["device"] = dev
        result["breakdown"] = {"device_ops": devtrace.top_ops(tr),
                               "idle_gaps": devtrace.idle_gaps(tr)}
    else:
        result["device"] = dev
    result["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the benchmark of pathtracerap_tpu_torch")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    import torch

    from ptbench import spec

    c = spec.cell(spec.load_benchmark(), args.workload)
    chips = c["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ptbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(c, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      chips=chips)
    leaked = loaded_forbidden()
    if leaked:
        print(f"ptbench: the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 3
    print(json.dumps({"card_power_limit_w": result["device"].get("power_limit_w")}),
          file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
