"""Finds a cell's files from its ``BENCHMARK.json`` entry, builds the
port's configuration from the configuration file, and formats the
result line.  Nothing here names a cell, a configuration or a metric:
each is found by the name the entry gives."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# file keys -> ModelConfig fields; each is checked against the port's
# configuration of the same arch, so the file states what is run.
CHECKED = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim", "intermediate_size": "d_ff",
    "vocab_size": "vocab_size", "rope_theta": "rope_theta",
    "mlp_gated": "mlp_gated", "dtype": "dtype",
}


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict[str, Any]
    config: Dict[str, Any]          # the configuration file
    traffic: Dict[str, Any]         # the traffic file
    serving: Dict[str, Any]         # traffic's serving settings + the cell's
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: Path


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(bench_dir(root) / "traffic"
                        / f"{entry['traffic']}.json")
    serving = dict(traffic.get("serving", {}))
    cell_file = bench_dir(root) / "cells" / f"{name}.json"
    if cell_file.exists():
        serving.update(load_json(cell_file).get("serving", {}))

    def mine(m):
        return name in m.get("workloads", [name])
    return Cell(name, entry, config, traffic, serving,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)], root)


def bench_dir(root: Path) -> Path:
    """The benchmark's folder inside the checkout at ``root``."""
    return root / HERE.name


def generator(cell: Cell) -> Callable:
    mod = importlib.import_module(
        f"{HERE.name}.generators.{cell.traffic['generator']}")
    return mod.generate


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    path = bench_dir(root) / "metrics" / f"{metric}.py"
    mod_name = "bench_metric_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_config(c: Dict[str, Any]):
    """The port's ModelConfig of the file's arch with the file's ``port``
    settings; raises where the file states another size than that
    configuration runs."""
    from repro_torch import configs
    over = {k: v for k, v in c.get("port", {}).items() if k != "why"}
    cfg = dataclasses.replace(configs.get(c["arch"]), **over)
    bad = {k: (c[k], getattr(cfg, f)) for k, f in CHECKED.items()
           if k in c and c[k] != getattr(cfg, f)}
    if bad:
        raise SystemExit(f"{c['name']}: the file and the port differ: {bad}")
    return cfg


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Any], device: Dict[str, Any],
                checks: Dict[str, Any], breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def forbidden_modules() -> List[str]:
    """Top-level names loaded that the port's benchmark must never load."""
    bad = {"jax", "jaxlib", "flax", "repro"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & bad)


def file_view(cfg) -> Dict[str, Any]:
    """A configuration file's keys for a port ModelConfig (the smoke
    configurations of the CPU tests)."""
    c = {k: getattr(cfg, f) for k, f in CHECKED.items()}
    c.update(name=cfg.name, arch=cfg.name, norm_eps=1e-6)
    return c
