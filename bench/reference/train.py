"""The plain reference of a train step: the GQA model of ``model.py``
in float32 (TF32 off), its next-token cross-entropy, its gradients and
an AdamW update, written from the published algorithm (Loshchilov and
Hutter; decoupled weight decay scaled by the learning rate, bias
corrections, the gradients clipped to a global norm first).

It fits beside nothing else on one card: the parameters and both
moments in float32 take 12 bytes a weight, and the gradients are never
all held.  The forward keeps each layer's input; the backward
recomputes one layer at a time under autograd and hands on the input's
gradient.  A step runs that backward twice: once for the global norm
the clip needs, once to update each layer's weights as its gradients
come.  The optimizer's settings are the traffic file's.

``lowp="fp8"`` is the control: every product with a weight matrix, in
the forward and in the backward, takes operands rounded to float8 e4m3
(``model._fp8``, passed straight through for the gradient).
``lowp="half_batch"`` plants a fault in the reference put in the
program's place: half the batch left out (half the rows, or of one
row's positions), the mean taken over the rest."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .model import F32, Reference, _fp8

BETA1, BETA2, EPS, WD, CLIP = 0.9, 0.95, 1e-8, 0.1, 1.0


class _StraightFp8(Reference):
    def mm(self, x, w):
        if self.lowp != "fp8":
            return x @ w
        qx = x + (_fp8(x.detach(), -1) - x).detach()
        qw = w + (_fp8(w.detach(), 0) - w).detach()
        return qx @ qw


def lr_at(opt: Dict, step: int) -> float:
    """Linear warmup to ``lr`` over ``warmup_steps``, then cosine to a
    tenth of it at ``total_steps``."""
    lr, w, n = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if step < w:
        return lr * (step + 1) / max(w, 1)
    t = min(max((step - w) / max(n - w, 1), 0.0), 1.0)
    return lr * (0.1 + 0.45 * (1 + math.cos(math.pi * t)))


class TrainReference:
    """Holds float32 parameters and moments on ``device``; ``step(batch)``
    runs one step and returns its loss."""

    def __init__(self, c: Dict, weights: Dict, device, opt: Dict,
                 lowp: Optional[str] = None):
        self.c, self.device, self.opt = c, device, opt
        self.ref = _StraightFp8(c, {}, device,
                                lowp if lowp == "fp8" else None)
        self.half = lowp == "half_batch"
        self.P = {k: self._f32(v) for k, v in self._flat(weights).items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.P.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.P.items()}
        self.n = 0
        self.first_grad: Dict[str, float] = {}

    def _f32(self, t):
        return t.to(self.device, F32).contiguous()

    @staticmethod
    def _flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(TrainReference._flat(v, f"{prefix}{k}/"))
            else:
                out[f"{prefix}{k}"] = v
        return out

    def _layer(self, i: int, x, p):
        """One layer over x (b, s, d), each row its own sequence."""
        r = self.ref
        attn = {n[len("blocks/attn/"):]: t for n, t in p.items()
                if n.startswith("blocks/attn/")}
        pos = torch.arange(x.shape[1], device=x.device)
        x = torch.stack([r.gqa(attn, row, pos) for row in x])
        return r.mlp({n[len("blocks/mlp/"):]: t for n, t in p.items()
                      if n.startswith("blocks/mlp/")}, x)

    def _block_names(self) -> List[str]:
        return [k for k in self.P if k.startswith("blocks/")]

    def _pass(self, tokens, labels, update: Optional[float]):
        """One forward and layer-wise backward.  Returns (loss, {leaf:
        squared gradient norm}); with ``update`` (the clip scale) applies
        AdamW to each slice of weights as its gradient comes."""
        P, r = self.P, self.ref
        L = P["blocks/attn/wq"].shape[0]
        names = self._block_names()
        sq: Dict[str, float] = {k: 0.0 for k in P}
        with torch.no_grad():
            xs = [P["embed"][tokens]]
            for i in range(L):
                xs.append(self._layer(i, xs[-1], {n: P[n][i] for n in names}))
        x = xs[-1].detach().requires_grad_()
        head = {n: P[n].detach().requires_grad_() for n in ("final_norm",
                                                            "unembed")}
        with torch.enable_grad():
            h = r.norm(x, head["final_norm"])
            logits = r.mm(h, head["unembed"])[..., :self.c["vocab_size"]]
            loss = (torch.logsumexp(logits, -1)
                    - logits.gather(-1, labels[..., None])[..., 0]).mean()
            gx, *gh = torch.autograd.grad(loss, [x] + list(head.values()))
        for (n, t), g in zip(head.items(), gh):
            self._take(n, None, g, sq, update)
        for i in reversed(range(L)):
            xi = xs[i].detach().requires_grad_()
            pl = {n: P[n][i].detach().requires_grad_() for n in names}
            with torch.enable_grad():
                out = self._layer(i, xi, pl)
                grads = torch.autograd.grad(out, [xi] + list(pl.values()), gx)
            gx = grads[0]
            for n, g in zip(pl, grads[1:]):
                self._take(n, i, g, sq, update)
        ge = torch.zeros_like(P["embed"])
        ge.index_add_(0, tokens.reshape(-1), gx.reshape(-1, gx.shape[-1]))
        self._take("embed", None, ge, sq, update)
        return float(loss.detach()), sq

    def _take(self, name, i, g, sq, scale):
        sq[name] += float(torch.linalg.vector_norm(g)) ** 2
        if scale is None:
            return
        gs = g * scale
        if self.n == 1:
            self.first_grad[name] = self.first_grad.get(name, 0.0) + float(
                torch.linalg.vector_norm(gs)) ** 2
        sel = (lambda t: t[i]) if i is not None else (lambda t: t)
        p, m, v = sel(self.P[name]), sel(self.m[name]), sel(self.v[name])
        lr = lr_at(self.opt, self.n - 1)
        bc1, bc2 = 1 - BETA1 ** self.n, 1 - BETA2 ** self.n
        m.mul_(BETA1).add_(gs * (1 - BETA1))
        v.mul_(BETA2).add_(gs * gs * (1 - BETA2))
        upd = (m / bc1) / (torch.sqrt(v / bc2) + EPS) + WD * p
        p.sub_(lr * upd)

    def step(self, tokens, labels) -> float:
        tokens = tokens.to(self.device).long()
        labels = labels.to(self.device).long()
        if self.half:
            b, n = tokens.shape
            cut = (slice(0, b // 2), slice(None)) if b > 1 else \
                (slice(None), slice(0, n // 2))
            tokens, labels = tokens[cut], labels[cut]
        loss, sq = self._pass(tokens, labels, None)
        norm = math.sqrt(sum(sq.values()))
        scale = min(CLIP / (norm + 1e-9), 1.0)
        self.n += 1
        self._pass(tokens, labels, scale)
        if self.n == 1:
            self.first_grad = {k: math.sqrt(v) for k, v in
                               self.first_grad.items()}
        return loss

    def change(self, weights0: Dict) -> Dict[str, float]:
        """Per leaf, the norm of the parameters' change from ``weights0``."""
        w0 = self._flat(weights0)
        return {k: float(torch.linalg.vector_norm(
            self.P[k] - self._f32(w0[k]))) for k in self.P}
