"""Run one cell of the benchmark of the PyTorch/CUDA port and print its result.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is ``benchmarks/workloads/<cell>.json``: its configuration
(``benchmarks/configs/<config>.json``, whose ``model_type`` names its model
family, ``benchmarks/families/<model_type>.py``: weights, the program's
model, the plain reference, the int8 products), its driver
(``benchmarks/drivers/<driver>.py``), its traffic mix and engine settings,
and the limits of its correctness check. Which metrics it reports comes
from ``BENCHMARK.json`` at the root of the checkout: with ``--trace 0`` the
end-to-end metrics that list the cell (or list no cells), with ``--trace
1`` the per-layer ones that list it, each read by
``benchmarks/metrics/<name>.py`` (or the file of the name's part before its
first dot) from the driver's counts and the device trace. Kernel families
for the trace are ``benchmarks/kernels/*.json``. A new cell,
configuration, model family, metric or kernel is a new file.

The run builds the cell's weights on the card from ``--seed``, warms up
(``setup_s`` runs from the process's start to the window's), measures for
``--seconds``, frees the program's state and compares a sample of what the
window served with the plain reference (``benchmarks/check.py``). The last
lines of standard error give each number compared with its limit; the
last line of standard output is the result, one JSON object. Without a
CUDA card (or with fewer cards than the cell asks for) it exits 2 and
prints no result, and it never runs on the CPU; it exits 3 and prints no
result if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "llmspeculativesampling_tpu")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is JAX's or the JAX package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(n for n in FORBIDDEN if n in tops)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    base: Path = HERE


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, seed: int, seconds: float, trace: bool, device,
              base: Path = HERE) -> Cell:
    workload = load_json(base / "workloads" / f"{name}.json")
    config = load_json(base / "configs" / f"{workload['config']}.json")
    return Cell(name, workload, config, int(seed), float(seconds), bool(trace), device, base)


def cell_metrics(spec: dict, cell: str, section: str) -> list:
    """The entries of ``spec[section]`` a cell reports: those that list it
    under ``workloads``, and end-to-end ones that list no cells. A per-layer
    metric must list its cells."""
    if section == "end_to_end":
        return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    for m in spec["per_layer"]:
        if "workloads" not in m:
            raise ValueError(f"per-layer metric {m['name']!r} lists no workloads")
    return [m for m in spec["per_layer"] if cell in m["workloads"]]


def reader(name: str, base: Path = HERE):
    """The metric reader of ``name``: ``metrics/<name>.py``, else the file
    of the part of the name before its first dot."""
    for stem in (name, name.split(".")[0]):
        path = base / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"benchmarks.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {name!r} under {base / 'metrics'}")


def driver(kind: str):
    return importlib.import_module(f"benchmarks.drivers.{kind}")


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: Optional[dict] = None) -> dict:
    """The result object: the five result keys, ``breakdown`` in a traced
    run, and the numbers compared last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def run_cell(cell: Cell, spec: dict) -> tuple:
    """Run ``cell`` on ``cell.device``; returns (result object, lines for
    standard error). The caller has checked for the card."""
    from benchmarks import check, trace

    spans = trace.Spans()
    tracer = trace.Tracer(cell.trace, spans)
    outcome = driver(cell.workload["driver"]).run(cell, tracer, spans)
    setup_s = outcome.window_start - _T0
    tr = tracer.read()
    metrics = {}
    if cell.trace:
        ctx = SimpleNamespace(counts=outcome.counts, trace=tr, widths=outcome.pair["widths"])
        for m in cell_metrics(spec, cell.name, "per_layer"):
            value = reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(outcome.end_to_end, setup_s=setup_s)
        for m in cell_metrics(spec, cell.name, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    chk = cell.workload["check"]
    gc.collect()
    t_ref = time.perf_counter()
    measured = check.gaps(outcome.pair, check.sample(outcome.answers, chk, cell.seed),
                          cell.device)
    t_ref = time.perf_counter() - t_ref
    correct, checks = check.judge(measured, chk, outcome.failed)
    device = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
              "kind": _device_name(cell.device), "count": int(cell.workload["chips"]),
              "memory_peak_bytes": outcome.memory_peak_bytes}
    breakdown = None
    if tr is not None:
        device.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    if cell.device.type == "cuda":
        device["power_limit"] = power_limit()
    lines = [f"setup_s {setup_s}", f"reference_s {t_ref}"]
    lines += [f"error {outcome.error}"] if outcome.error else []
    lines += check.describe(checks)
    return result_line(correct, outcome.attempted, outcome.failed, metrics, device, checks,
                       breakdown), lines


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_card(chips: int):
    """The CUDA device, or SystemExit(2) when there are fewer cards than the
    cell asks for: the benchmark never runs on the CPU."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}", file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda", 0)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = load_cell(args.workload, args.seed, args.seconds, bool(args.trace), None)
    cell.device = require_card(int(cell.workload["chips"]))
    result, lines = run_cell(cell, spec)
    found = forbidden_modules()
    if found:
        print(f"refusing to report: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
