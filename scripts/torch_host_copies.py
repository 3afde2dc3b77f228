#!/usr/bin/env python3
"""Which host-side operations wait for the card, on one GPU.

    python3 scripts/torch_host_copies.py

Each case runs while the card spins on a ~100 ms kernel
(``torch.cuda._sleep``) and prints the host ms it took and whether the card
was still busy when it returned: a case that waits for the spin returns
after it, with the card idle. The serving engines' one-deep pipeline
(``serve/batched.py``) relies on the cases that do not wait: pinned memory
copied with ``non_blocking=True`` (``to_device``) and scalar fills
(``index_fill_``); a copy from pageable memory, ``torch.tensor(...,
device=)`` and an indexed write of a Python scalar wait. Every line carries
the card's name and power limit. It imports nothing of JAX.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

SPIN_CYCLES = int(2e8)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


def case(name: str, fn, card: str, reps: int = 5) -> None:
    stream = torch.cuda.current_stream()
    for r in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        fn(r)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"[host_copies] {name} rep {r}: {ms:.3f} host ms, card still busy after: "
              f"{not stream.query()} ({card})", flush=True)
    torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_host_copies: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from llmspeculativesampling_tpu_torch.serve.batched import to_device

    dev, card = torch.device("cuda"), card_line()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(SPIN_CYCLES)
    torch.cuda.synchronize()
    print(f"[host_copies] the spin takes {(time.perf_counter() - t0) * 1e3:.1f} ms ({card})")
    x = torch.zeros(16, dtype=torch.bool, device=dev)
    rows = torch.tensor([1, 2], device=dev)
    case("pin_memory of a new size", lambda r: torch.empty(1000 + 17 * r).pin_memory(), card)
    case("to_device (pinned, non_blocking)", lambda r: to_device(np.arange(7), torch.long, dev),
         card)
    case("as_tensor(...).to(device) from pageable memory",
         lambda r: torch.as_tensor(np.arange(7)).to(dev), card)
    case("torch.tensor(list, device=)", lambda r: torch.tensor([1, 2, 3], device=dev), card)
    case("x[list] = False", lambda r: x.__setitem__([1, 2], False), card)
    case("x[device index] = False", lambda r: x.__setitem__(rows, False), card)
    case("x.index_fill_(0, device index, False)", lambda r: x.index_fill_(0, rows, False), card)
    case("an event recorded", lambda r: torch.cuda.Event(enable_timing=True).record(), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
