"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload memcache.panel96 --seed 7 \
        --seconds 30 --trace 0

One run: set-up (import the program, load or build its kernels, draw the
cell's inputs from the seed, warm up every shape the jobs use), then a
closed loop with one client that sends the cell's jobs one after another
for `--seconds`, then the judge (the plain reference, on the host, once
the program's state is freed). With `--trace 0` the result carries the
cell's end-to-end metrics; with `--trace 1` the window runs under
`torch.profiler` and the result carries its per-layer metrics, the
device's busy and window seconds and a breakdown.

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, optionally `breakdown`, and
last `checks`, each number compared beside its limit); the last lines of
standard error are the same numbers. A run with no card, too few cards, or
JAX loaded prints no result and exits with 2, 3 or 4.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in (names or sys.modules)}
                  & set(FORBIDDEN))


def children() -> list:
    """This process's live child processes, as (pid, command line)."""
    pids = set()
    for task in Path("/proc/self/task").iterdir():
        with contextlib.suppress(OSError):
            pids |= set((task / "children").read_text().split())
    found = []
    for pid in sorted(pids, key=int):
        with contextlib.suppress(OSError):
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
            found.append((int(pid), cmd.replace(b"\0", b" ").decode(
                errors="replace").strip()))
    return found


def end_children() -> list:
    """Kill and wait for every child process still alive: none should be,
    and none may outlive the run. Returns what it found."""
    found = children()
    for pid, _ in found:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, 0)
    return found


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str | None = None, workers: int | None = None) -> dict:
    """One run of `cell` (a `spec.Cell`); returns the result's fields.
    `device=None` is the program's default, the card."""
    from portbench import devtrace, spec
    import torch
    kind = spec.job_kind(cell.traffic["job"])
    t_before = time.perf_counter() - T_START
    on_card = device is None or str(device).startswith("cuda")
    state = kind.setup(cell.config, cell.traffic, seed, device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    per_job = kind.work(state)
    jobs, outputs, failed = [], [], 0
    prof: dict = {}
    window = (devtrace.profiled(prof) if trace else nullcontext())
    spans = (devtrace.spans_around(kind.SPANS) if trace else nullcontext())
    with window, spans:
        # a traced window opens once the profiler has started
        t_open = time.perf_counter()
        j = 0
        while j == 0 or time.perf_counter() - t_open < seconds:
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(devtrace.JOB_SPAN):
                    out = kind.run(state, j)
            except Exception:     # a job that raises is failed, not timed
                traceback.print_exc()
                failed += 1
                break
            t1 = time.perf_counter()
            jobs.append(devtrace.Job(t0, t1, per_job))
            outputs.append((j, out))
            j += 1
    attempted = len(jobs) + failed
    window_s = (jobs[-1].end - t_open) if jobs else 0.0
    memory_peak = (torch.cuda.max_memory_allocated() if on_card else 0)
    kind.free(state)
    if on_card:
        torch.cuda.empty_cache()
    record = devtrace.RunRecord(jobs=jobs, window_s=window_s,
                                setup_s=setup_s, facts=state.facts,
                                trace=prof.get("trace"))
    t_judge = time.perf_counter()
    checks, details = kind.judge(state, outputs,
                                 workers=workers or kind.reference_workers())
    details["judge_s"] = time.perf_counter() - t_judge
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(0) if on_card
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if record.trace is not None:
        lo, hi = record.trace.window
        merged = devtrace.union((max(a, lo), min(b, hi))
                                for _, a, b in record.trace.device)
        dev["busy_s"] = devtrace.busy_within(merged, lo, hi)
        dev["window_s"] = hi - lo
        result["breakdown"] = devtrace.breakdown(record.trace)
    result["details"] = {**details, "jobs": len(jobs),
                         "window_s": window_s, "setup_s": setup_s,
                         "setup_parts_s": {"imports_and_device": t_before,
                                           **state.setup_parts}}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    from portbench import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards; "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    finally:
        for pid, cmd in end_children():
            print(f"ended a child process left running: {pid} {cmd}",
                  file=sys.stderr)
    named = (f"{torch.cuda.get_device_name(0)} x "
             f"{torch.cuda.device_count()}, power.limit {_power_limit()}, "
             f"torch {torch.__version__}")
    print(f"device: {named}", file=sys.stderr)
    result["details"]["device"] = named
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)} (JAX or the "
              "JAX package); no result", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
