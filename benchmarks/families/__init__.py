"""Model families: what the harness does differently for each kind of model.

A configuration file names its family by ``model_type``, and the family is
``families/<model_type>.py``, found by that name and loaded by path, as the
metric readers are. A family module provides:

- ``widths(cfg)``: ``{"draft": w, "target": w}``, each role's sizes. Each
  ``w`` holds ``family`` (the ``model_type``), ``layers``, ``hidden``,
  ``heads``, ``kv_heads``, ``head_dim`` and ``vocab``, and whatever else the
  family's own functions read;
- ``build(cfg, seed, device)``: ``{"draft": params, "target": params,
  "widths": widths(cfg)}``, the pair born on ``device`` from ``seed``;
- ``bundles(pair, kv_quant)``: ``{role: ModelBundle}`` of the program for
  that pair (the one place a family imports the program, inside the call);
- ``reference``: the plain reference, with ``setup_precision()``,
  ``head_weight(params)``, ``final_hidden(params, w, seqs, act_quant=None)``
  and ``logits(head, hidden, act_quant=None)``;
- ``projections(w, m)``: ``(rows, K, N)`` of each int8 product one layer of
  widths ``w`` makes in a forward of ``m`` token rows.

A family's widths carry its name, so the roofline and the metric readers
find the family from the widths alone (``of``).
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _module_name(model_type: str) -> str:
    return f"benchmarks.families.{model_type}"


def family(config: dict, base: Path = HERE):
    """The family module of ``config``: ``<base>/families/<model_type>.py``,
    else the harness's own ``families/<model_type>.py``. The module is kept
    under its name, so ``of`` finds the one loaded last."""
    name, base = config.get("name", "<unnamed>"), Path(base)
    if "model_type" not in config:
        raise ValueError(f"configuration {name!r} names no model_type: its family would be "
                         f"{base / 'families' / '<model_type>.py'}")
    model_type = config["model_type"]
    paths = [base / "families" / f"{model_type}.py"]
    if base.resolve() != HERE:
        paths.append(HERE / "families" / f"{model_type}.py")
    for path in paths:
        if path.exists():
            return _load(model_type, path)
    raise FileNotFoundError(f"configuration {name!r}: no family for model_type "
                            f"{model_type!r}; looked for {' and '.join(map(str, paths))}")


def _load(model_type: str, path: Path):
    key = _module_name(model_type)
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules[key] = mod
    return mod


def of(widths: dict):
    """The family of a role's widths (their ``family`` key): the module
    ``family`` loaded last under that name, else the harness's own."""
    return importlib.import_module(_module_name(widths["family"]))
