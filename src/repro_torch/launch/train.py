"""End-to-end training entry point (port of ``launch/train.py``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \
        --smoke --device cpu --steps 50 --batch 4 --seq 64 --ckpt-dir ckpt

Runs on ``--device cuda`` by default (one card); ``--device cpu`` trains
there.  Weights are random, drawn from ``--seed`` on the device in the
model dtype (``cfg.dtype``: bf16 at full width, fp32 with ``--smoke``);
the AdamW moments are fp32.  The batches come from the synthetic data
pipeline over a bounded Stream (depth-2 ping-pong), the step from
``train.train_loop.make_train_step``; ``--ckpt-dir`` saves every
``--ckpt-every`` steps and ``--resume`` continues from ``LATEST``.
``--zero1`` is accepted and, on one device, changes nothing (the
reference's without a mesh neither).

``main`` returns ``{"params", "opt_state", "steps"}``, ``steps`` holding
per step its ``loss`` and ``grad_norm`` (floats), ``lr`` and ``seconds``
(wall time, the device synchronised).
"""

import argparse
import time

import torch

from ..configs import get as get_arch
from ..configs.base import smoke_variant
from ..models import registry
from ..models.transformer import torch_dtype
from ..train import (checkpoint as CK, data as D, fault as F,
                     optimizer as OPT, train_loop as TL)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to train on the CPU)")
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch={cfg.name} params={registry.num_params(cfg)/1e6:.1f}M "
          f"devices=1 ({name})")

    tcfg = TL.TrainCfg(
        opt=OPT.OptCfg(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps),
        grad_accum=args.grad_accum, zero1=args.zero1)
    step_fn = TL.make_train_step(cfg, tcfg)

    params = registry.init(cfg, args.seed, device=device,
                           dtype=torch_dtype(cfg.dtype))
    opt_state = OPT.init(params)
    start = 0
    if args.resume and args.ckpt_dir and CK.latest_step(args.ckpt_dir):
        state, start, _ = CK.restore(args.ckpt_dir,
                                     {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        print(f"resumed from step {start}")

    dcfg = D.DataCfg(global_batch=args.batch, seq_len=args.seq,
                     seed=args.seed)
    pipe = D.DataPipeline(cfg, dcfg, depth=2, start_step=start,
                          num_steps=args.steps - start)
    detector = F.StragglerDetector()
    steps = []
    t_start = time.time()
    try:
        for step in range(start, args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in pipe.next().items()}
            t0 = time.time()
            params, opt_state, m = step_fn(params, opt_state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.time() - t0
            steps.append({"step": step, "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "lr": m["lr"], "seconds": dt})
            if detector.observe(dt):
                print(f"step {step}: STRAGGLER ({dt:.2f}s vs "
                      f"{detector.mean:.2f}s mean)")
            if step % args.log_every == 0 or step == args.steps - 1:
                toks = args.batch * args.seq / dt
                print(f"step {step:5d} loss {steps[-1]['loss']:.4f} "
                      f"gnorm {steps[-1]['grad_norm']:.3f} "
                      f"lr {m['lr']:.2e} {toks:,.0f} tok/s")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                CK.save(args.ckpt_dir, step + 1,
                        {"params": params, "opt": opt_state})
                CK.prune(args.ckpt_dir)
    finally:
        pipe.close()
    print(f"done: {args.steps - start} steps in {time.time()-t_start:.1f}s")
    return {"params": params, "opt_state": opt_state, "steps": steps}


if __name__ == "__main__":
    main()
