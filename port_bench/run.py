"""Run one cell of the benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/``
and the program (``ivid_tpu_torch``). The cell's entry in ``BENCHMARK.json``
names its configuration (``port_bench/configs/<config>.json``) and traffic
mix (``port_bench/traffic/<traffic>.json``, whose ``kind`` names the driver
``port_bench/drivers/<kind>.py``); its limits are
``port_bench/limits/<cell>.json`` and each per-layer metric is read by
``port_bench/layer_metrics/<metric>.py``. With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``, each number compared with its limit
(also the last lines of standard error). Without a card, with fewer cards
than the cell asks for, without the program beside the benchmark, or when a
module of JAX or of the JAX package is loaded, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import os
import sys
import time

_T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".port_bench_cache")

# Build and kernel caches at fixed paths inside the checkout, so only the
# first run in a checkout builds; no library the program uses may load JAX.
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "nv"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# The checkout's root, not this file's folder, is where imports start.
sys.path = [ROOT] + [p for p in sys.path
                     if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ivid_tpu")


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was loaded."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


class Run:
    """What a driver is given: the cell's configuration and traffic, the
    seed, the window's length, whether to trace, the device; and the marks
    it sets (set-up done, the memory peak)."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
                 trace: bool, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self._age0 = _process_age_s() - (time.perf_counter() - _T0)
        self.setup_s = None
        self.memory_peak_bytes = 0

    def setup_done(self) -> None:
        from port_bench import device as devices

        devices.sync(self.device)
        self.setup_s = self._age0 + (time.perf_counter() - _T0)

    def memory_peak(self) -> None:
        from port_bench import device as devices

        self.memory_peak_bytes = devices.peak_bytes(self.device)


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(manifest: dict, workload: str) -> dict:
    """The cell's entry and the paths of its configuration, traffic and
    limits files."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    return {"cell": cell,
            "config": os.path.join(ROOT, "port_bench", "configs", cell["config"] + ".json"),
            "traffic": os.path.join(ROOT, "port_bench", "traffic", cell["traffic"] + ".json"),
            "limits": os.path.join(ROOT, "port_bench", "limits", workload + ".json")}


def layer_metrics(manifest: dict, workload: str) -> list:
    """The per-layer metrics this cell reports: those whose ``workloads``
    list it (every per-layer entry has the list)."""
    return [m for m in manifest["per_layer"] if workload in m["workloads"]]


def end_to_end(manifest: dict, workload: str) -> list:
    return [m for m in manifest["end_to_end"]
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def read_layer_metric(metric: dict, facts: dict, run: Run):
    path = os.path.join(ROOT, "port_bench", "layer_metrics", metric["name"] + ".py")
    mod = load_file_module(path, "port_bench_layer_" + metric["name"].replace(".", "_"))
    return mod.read(facts, run)


def judge(readings: dict, limits: dict):
    """``(correct, checks)``: every reading at or under its limit."""
    checks, ok = {}, True
    for name, value in readings.items():
        if name not in limits:
            raise KeyError(f"reading {name!r} has no limit")
        checks[name] = {"value": value, "limit": limits[name]}
        ok = ok and value == value and value <= limits[name]
    return ok, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    manifest = load_json("BENCHMARK.json")
    files = cell_files(manifest, args.workload)
    config, traffic = load_json(files["config"]), load_json(files["traffic"])
    limits = load_json(files["limits"])
    if importlib.util.find_spec("ivid_tpu_torch") is None:
        print("the program (ivid_tpu_torch) is not beside the benchmark", file=sys.stderr)
        return 4

    import torch

    chips = int(files["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    driver = importlib.import_module(f"port_bench.drivers.{traffic['kind']}")
    run = Run(files["cell"], config, traffic, args.seed, args.seconds, bool(args.trace), device)
    out = driver.run(run)
    result = assemble(manifest, args.workload, run, out, limits)

    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def assemble(manifest: dict, workload: str, run: Run, out: dict, limits: dict) -> dict:
    """The result object of one run from the driver's output."""
    import torch

    e2e = end_to_end(manifest, workload)
    values = dict(out["metrics"], setup_s=run.setup_s)
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                       else "cpu"),
              "count": int(run.cell["chips"]),
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": None, "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    if not run.trace:
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in e2e}
    else:
        facts = dict(out["facts"], device_kind=device["kind"])
        metrics = {}
        for m in layer_metrics(manifest, workload):
            v = read_layer_metric(m, facts, run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        tr = facts.get("trace")
        if tr is None or not tr.device:
            raise RuntimeError("the profiler recorded no device activity in the traced window")
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["device"] = device
    correct, checks = judge(out["readings"], limits)
    result["correct"] = bool(correct and out["failed"] == 0)
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
