"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in BENCHMARK.json; its configuration
(``configs/<config>.json``), traffic mix (``traffic/<traffic>.json``), the
mix's entry (``entries/<entry>.py``), the cell's limits
(``limits/<workload>.json``) and each metric's reader
(``metrics/<metric>.py``) are found by the names given there, so a new
cell, mix or metric is new files and entries, never an edit.

An entry module has ``setup(run) -> state``, ``window(run, state) ->
record`` and ``check(run, state, record) -> {number: value}``. The record
holds what the metrics read: ``wall_s``, the work done, the stage totals,
the trace slice's summary. The check runs after the window has closed and
the device's peak memory has been read; each number it returns is held to
its limit (value <= limit), and the run is correct when every one holds.
"""

import argparse
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
import zlib
from contextlib import nullcontext

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "ribodetector_tpu")


class NoDevice(RuntimeError):
    """The cell's cards are not there: no result is printed."""


def process_start():
    """This process's start on the perf_counter clock (Linux /proc; the
    interpreter's own start-up included)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def load_json(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as fh:
        return json.load(fh)


def load_module(kind, name):
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (ribodetector_tpu_torch is not ribodetector_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """One run's settings and scratch space, handed to the entry."""

    def __init__(self, cell, seed, seconds, trace, device, tmp, overrides=None):
        self.cell = cell
        self.cfg = load_json("configs", f"{cell['config']}.json")
        self.mix = load_json("traffic", f"{cell['traffic']}.json")
        for key, value in (overrides or {}).items():
            self.mix[key] = value
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.tmp = device, tmp
        self.weights = os.path.join(REPO, self.cfg["weights"])

    def rng(self, tag):
        """A generator of its own for each use, from --seed."""
        import numpy as np

        return np.random.default_rng([self.seed % 2**63, zlib.crc32(tag.encode())])

    def span(self, name):
        """A profiler range in a traced run (names the idle gaps)."""
        if not self.trace:
            return nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def sync(self):
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def path(self, *parts):
        p = os.path.join(self.tmp, *parts)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(run, peak):
    import torch

    if run.device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": int(run.cell["chips"]), "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def metrics_for(bench, cell, trace, record):
    """The cell's metrics of the run's kind, each from its reader; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(argv=None, device="cuda", overrides=None, t_start=None):
    """One run -> the result dict (printed by main). device="cpu" and
    overrides (mix keys) are for the CPU tests: the measured command always
    asks for the card."""
    t_start = process_start() if t_start is None else t_start
    args = parse_args(argv)
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        raise SystemExit(f"unknown workload {args.workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[args.workload]
    limits = load_json("limits", f"{cell['name']}.json")
    sys.path.insert(0, REPO)  # the program under test, from the checkout
    import torch

    if device == "cuda" and not (torch.cuda.is_available()
                                 and torch.cuda.device_count() >= cell["chips"]):
        raise NoDevice(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                       f"torch sees {torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp(prefix="rdbench-")
    # the program's parity-marker cache: a directory of this run's own, so
    # that every run's set-up probes as a user's first library does
    os.environ["RIBODETECTOR_TPU_TORCH_CACHE"] = os.path.join(tmp, "marker-cache")
    try:
        run = Run(cell, args.seed, args.seconds, bool(args.trace), device, tmp, overrides)
        entry = load_module("entries", run.mix["entry"])
        state = entry.setup(run)
        run.sync()
        setup_s = time.perf_counter() - t_start
        record = entry.window(run, state)
        record["setup_s"] = setup_s
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        numbers = entry.check(run, state, record)
        compared = {}
        for name, value in numbers.items():
            if name not in limits:
                raise KeyError(f"limits/{cell['name']}.json has no limit for {name}")
            compared[name] = {"value": value, "limit": limits[name]["limit"]}
        correct = all(c["value"] <= c["limit"] for c in compared.values())
        result = {
            "correct": correct,
            "attempted": int(record["attempted"]),
            "failed": int(record["failed"]),
            "metrics": metrics_for(bench, cell, run.trace, record),
            "device": device_info(run, peak),
        }
        if run.trace:
            summary = record["trace"]
            result["device"]["busy_s"] = summary["busy_s"]
            result["device"]["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": [list(x) for x in summary["device_ops"]],
                                   "idle_gaps": [list(x) for x in summary["idle_gaps"]]}
        result["compared"] = compared
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    t_start = process_start()
    try:
        result = run_cell(argv, t_start=t_start)
    except NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    except Exception:  # noqa: BLE001 - a failed run prints no result
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
