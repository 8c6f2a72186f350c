"""One run of a cell, whatever its mode: the driver of the mode, the
comparison that decides ``correct``, the per-layer readers of a traced
run, and the result line."""

from __future__ import annotations

import gc
import sys
from typing import Any, Dict, Optional

from . import harness


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def limits(cell: harness.Cell) -> Dict[str, float]:
    """The numbers ``cells/<cell>.json`` holds to a limit."""
    path = harness.bench_dir(cell.root) / "cells" / f"{cell.name}.json"
    if not path.exists():
        return {}
    return harness.load_json(path).get("limits", {})


def checks_of(readings: Dict[str, float], lim: Dict[str, float]
              ) -> Dict[str, Any]:
    """Each number the cell's file holds to a limit, beside it."""
    return {k: {"value": readings[k], "limit": v} for k, v in lim.items()}


def passed(checks: Dict[str, Any]) -> bool:
    """True when the cell holds at least one number and each is within
    its limit."""
    return bool(checks) and all(c["value"] <= c["limit"]
                                for c in checks.values())


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, cfg=None, lowp: Optional[str] = None,
             ) -> Optional[str]:
    """The result line of one run of ``cell``, or None when the run may
    print none (JAX loaded, or a traced run that recorded nothing on the
    card).  ``cfg`` replaces the configuration file's (smoke width on the
    CPU); with ``lowp`` the control or a planted fault is judged in the
    program's place (``control.py``)."""
    from .device import identity
    mode = cell.traffic["mode"]
    if mode == "serve":
        from . import serve as drv
    elif mode == "train":
        from . import train as drv
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    out = drv.run(cell, seed, seconds, trace, device, cfg=cfg,
                  t_start=t_start, log=log)
    dev = identity(int(cell.entry["chips"])) if device.type == "cuda" else \
        {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = int(out["peak"])
    bad = harness.forbidden_modules()
    if bad:
        log(f"loaded after the window: {bad}")
        return None
    judged = drv.judge(out, cell, seed, device, lowp=lowp)
    # with ``lowp`` the control stands in the program's place: its
    # readings are the ones held to the cell's limits
    side = "control" if lowp else "program"
    chk = checks_of(judged[side], limits(cell))
    correct = passed(chk)
    for s, r in judged.items():
        log(f"judged {s}: {r}")
    for k in ("params", "finished", "w0", "batch"):
        out.pop(k, None)
    gc.collect()
    breakdown = None
    if trace:
        ctx = out["ctx"]
        prof = ctx.get("profile")
        metrics = {}
        for m in cell.per_layer:
            v = harness.reader(m["name"], cell.root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if prof is None and device.type == "cuda":
            log("the traced window recorded nothing on the device")
            return None
        if prof is not None:
            dev["busy_s"] = prof["busy_s"]
            dev["window_s"] = prof["window_s"]
            breakdown = {"device_ops": prof["device_ops"],
                         "idle_gaps": prof["idle_gaps"]}
    else:
        metrics = {m["name"]: {"value": float(out["metrics"][m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out["metrics"]}
    for k, c in chk.items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    return harness.result_line(correct, out["attempted"], out["failed"],
                               metrics, dev, chk, breakdown)
