"""Read a cell's correctness numbers on the chip: the program's widest greedy
logit gap and the control's (the reference in float8 activations, the
precision below the configuration's bf16, put in the program's place), for
several seeds in one process. The limits in the workload files are set
from these readings; the benchmark's own runs never run the control.

    python3 benchmarks/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

Prints one JSON line a seed: the seed, ``logit_gap``, ``control_gap``,
``served_checked`` and the run's end-to-end values.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmarks import check, run, trace  # noqa: E402


def read_seed(name: str, seed: int, seconds: float, device) -> dict:
    cell = run.load_cell(name, seed, seconds, False, device)
    spans = trace.Spans()
    t0 = time.perf_counter()
    outcome = run.driver(cell.workload["driver"]).run(cell, trace.Tracer(False, spans), spans)
    setup = outcome.window_start - t0
    gc.collect()
    chosen = check.sample(outcome.answers, cell.workload["check"], seed)
    t1 = time.perf_counter()
    got = check.gaps(outcome.pair, chosen, device, control=True, seed=seed)
    out = {"seed": seed, **got, "reference_s": time.perf_counter() - t1, "setup_s": setup,
           "failed": outcome.failed, "error": outcome.error, **outcome.end_to_end,
           "memory_peak_bytes": outcome.memory_peak_bytes}
    del outcome
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell = run.load_cell(args.workload, 0, args.seconds, False, None)
    device = run.require_card(int(cell.workload["chips"]))
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(read_seed(args.workload, seed, args.seconds, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
