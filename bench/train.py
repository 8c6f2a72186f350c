"""The training cells: the port's train step (``train_loop.
make_train_step``, AdamW) on batches drawn from the seed, timed by the
host clock around steps that end in a read of the loss.

Set-up builds one object, the step with its model and optimizer state,
drives it through its first three steps (each on its own batch) and
hands that same object to the window.  Those three steps are the ones
judged: each step's loss, the first gradient as the optimizer got it
(from its first moment after one step, m / (1 - beta1)) and the
parameters' change after the three, each leaf's norm against the
float32 reference's (``reference/train.py``) started from the same
weights on the same batches.  The window then runs steps until one
ends past ``--seconds``; the rate counts every step the window started
over the time to the last one's end."""

from __future__ import annotations

import statistics
import sys
import time
from typing import Any, Dict, Optional

import torch

from . import harness
from .device import Profile

CLOCK = time.perf_counter
JUDGED = 3


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().float()))


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
        cfg=None, t_start: float = 0.0, log=None) -> Dict[str, Any]:
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_loop as TL
    from . import weights as W
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cfg = cfg or harness.port_config(cell.config)
    p = cell.traffic["params"]
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
        torch.cuda.reset_peak_memory_stats()
    params = W.draw(cfg, seed, device, dtype=getattr(torch, cfg.dtype))
    w0 = {k: v.detach().to("cpu", copy=True)
          for k, v in _leaves(params).items()}
    opt_state = OPT.init(params)
    ocfg = OPT.OptCfg(lr=p["lr"], warmup_steps=p["warmup_steps"],
                      total_steps=p["total_steps"])
    step = TL.make_train_step(cfg, TL.TrainCfg(opt=ocfg))
    batch = harness.generator(cell)(p, seed, vocab=cfg.vocab_size,
                                    device=device)
    losses, first_grad = [], {}
    for k in range(JUDGED):
        params, opt_state, m = step(params, opt_state, batch(k))
        losses.append(float(m["loss"]))
        if k == 0:
            first_grad = {n: _norm(t) / (1 - ocfg.beta1)
                          for n, t in _leaves(opt_state.m).items()}
    change = {n: _norm(t.float() - w0[n].to(device).float())
              for n, t in _leaves(params).items()}

    prof = Profile(CLOCK) if trace and device.type == "cuda" else None
    steps = []
    tokens = int(p["batch"]) * int(p["seq"])
    t0 = CLOCK()
    k = JUDGED
    while True:
        if prof is not None and len(steps) == 2 and prof.t0 is None:
            prof.start()
        s0 = CLOCK()
        params, opt_state, m = step(params, opt_state, batch(k))
        float(m["loss"])
        s1 = CLOCK()
        steps.append({"start": s0, "end": s1, "batch": int(p["batch"]),
                      "seq": int(p["seq"]),
                      "profiled": prof is not None and prof.active})
        if prof is not None and prof.active and len(steps) == 4:
            prof.stop()
        k += 1
        if s1 >= t0 + seconds:
            break
    if prof is not None and prof.active:
        prof.stop()
    t1 = steps[-1]["end"]
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    metrics = {"train_tokens_per_s": len(steps) * tokens / (t1 - t0),
               "setup_s": t0 - t_start}
    med = statistics.median(s["end"] - s["start"] for s in steps)
    log(f"window {t0 - t_start:.3f}..{t1 - t_start:.3f} s: {len(steps)} "
        f"steps, median {med * 1e3:.1f} ms; losses {losses}")
    ctx = None
    if trace:
        ctx = {"steps": steps, "t0": t0, "t1": t1, "config": cell.config,
               "seconds": seconds,
               "profile": prof.summary() if prof is not None else None}
    del params, opt_state, m, step
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return {"metrics": metrics, "attempted": len(steps), "failed": 0,
            "peak": peak, "ctx": ctx, "w0": w0, "cfg": cfg,
            "losses": losses, "first_grad": first_grad, "change": change,
            "batch": batch, "window": (t0, t1, t1)}


def gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None
         ) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the larger of the reference's norm of that leaf
    and of the median leaf."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def judge(out: Dict[str, Any], cell: harness.Cell, seed: int, device,
          lowp: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """The three judged steps against the float32 reference: {"program":
    readings} and, with ``lowp``, {"control": the same readings of the
    reference run in the control's precision, or with a planted fault,
    in the program's place}."""
    from .reference.train import TrainReference
    w0 = out["w0"]
    opt = {k: cell.traffic["params"][k]
           for k in ("lr", "warmup_steps", "total_steps")}

    def follow(lp):
        ref = TrainReference(cell.config, w0, device, opt, lowp=lp)
        losses = []
        for k in range(JUDGED):
            b = out["batch"](k)
            losses.append(ref.step(b["tokens"], b["labels"]))
        res = (losses, dict(ref.first_grad), ref.change(w0))
        del ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return res

    with torch.no_grad():
        r_loss, r_grad, r_change = follow(None)
    med = statistics.median(r_grad.values())
    # leaves whose gradient is nought to rounding move by round-off alone
    moving = {n for n, g in r_grad.items() if g >= 1e-3 * med}

    def readings(loss, grad, change):
        return {"loss_gap": max(abs(a - b) / abs(b)
                                for a, b in zip(loss, r_loss)),
                "grad_gap": gaps(grad, r_grad),
                "change_gap": gaps(change, r_change, moving)}
    res = {"program": readings(out["losses"], out["first_grad"],
                               out["change"])}
    if lowp:
        with torch.no_grad():
            res["control"] = readings(*follow(lowp))
    return res
