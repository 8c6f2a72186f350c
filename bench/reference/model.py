"""The plain reference: a decoder's forward in float32, written from the
published equations with plain ``torch`` operations.  It imports
nothing of the program and takes from the harness only the weights the
harness drew and the token ids it served.

GQA (minitron-4b): pre-norm blocks; attention with ``hq`` query and
``hkv`` key/value heads of ``head_dim``, rotary over the whole head (the
two halves rotated, theta ``rope_theta``), causal softmax scaled by
1/sqrt(head_dim); an MLP of ``intermediate_size``, gated SiLU where the
configuration file's ``mlp_gated`` is true, else ungated with the tanh
approximation of GELU.

Departures from the published model, each what the configuration file
states and lists in ``reduced``: RMSNorm with the weight as (1 + w) at
the file's ``norm_eps`` (published: LayerNorm1p), rotary over the whole
head (published: half), GELU-tanh (published: squared ReLU).

Weights come as the harness's tree (bf16 leaves stacked over layers,
matrices laid out (in, out)); each layer is read once, in float32, when
the forward reaches it.  The forward runs one sequence at a time, keys
in blocks of query rows, and logits only at the rows asked for.

``lowp="fp8"`` runs the control: every product with a weight matrix
takes both operands rounded to float8 e4m3 (a scale per weight column
and per activation row, each at 448 for its largest magnitude), as a
program with fp8 GEMMs would; everything else stays float32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

F32 = torch.float32
E4M3_MAX = 448.0


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


class Reference:
    def __init__(self, c: Dict, weights: Dict, device, lowp: Optional[str]
                 = None):
        self.c, self.w, self.device, self.lowp = c, weights, device, lowp
        no_tf32()

    # -- primitives ---------------------------------------------------------

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., in) @ w (in, out), both float32."""
        if self.lowp == "fp8":
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        eps = self.c.get("norm_eps", 1e-6)
        return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
            * (1.0 + w)

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (s, ..., d): the two halves of d rotated by pos times
        theta^(-i / half)."""
        d = x.shape[-1]
        half = d // 2
        inv = float(self.c["rope_theta"]) ** (
            -torch.arange(half, dtype=F32, device=x.device) / half)
        ang = pos.to(F32)[:, None] * inv
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (half,)
        cos, sin = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    @staticmethod
    def attend(q, k, v, scale: float, block: int = 512) -> torch.Tensor:
        """Causal attention, q (s, h, dk), k (s, h, dk), v (s, h, dv), the
        key heads already repeated to the query heads; in blocks of query
        rows."""
        s = q.shape[0]
        out = []
        kt = k.permute(1, 2, 0)                          # (h, dk, s)
        vv = v.transpose(0, 1)                           # (h, s, dv)
        for r0 in range(0, s, block):
            r1 = min(r0 + block, s)
            sc = torch.matmul(q[r0:r1].transpose(0, 1), kt[..., :r1]) * scale
            qi = torch.arange(r0, r1, device=q.device)[:, None]
            ki = torch.arange(r1, device=q.device)[None, :]
            sc = sc.masked_fill(ki > qi, float("-inf"))
            p = torch.softmax(sc, -1)
            out.append(torch.matmul(p, vv[:, :r1]).transpose(0, 1))
        return torch.cat(out, 0)

    def swiglu(self, h, wg, wu, wd):
        return self.mm(torch.nn.functional.silu(self.mm(h, wg))
                       * self.mm(h, wu), wd)

    # -- blocks -------------------------------------------------------------

    def gqa(self, p, x, pos):
        c = self.c
        hq, hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                       c["head_dim"])
        s = x.shape[0]
        h = self.norm(x, p["norm"])
        q = self.rope(self.mm(h, p["wq"]).view(s, hq, hd), pos)
        k = self.rope(self.mm(h, p["wk"]).view(s, hkv, hd), pos)
        v = self.mm(h, p["wv"]).view(s, hkv, hd)
        g = hq // hkv
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        o = self.attend(q, k, v, 1.0 / math.sqrt(hd))
        return x + self.mm(o.reshape(s, hq * hd), p["wo"])

    def mlp(self, p, x):
        h = self.norm(x, p["norm"])
        if self.c.get("mlp_gated", True):
            return x + self.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
        u = torch.nn.functional.gelu(self.mm(h, p["w_up"]), approximate="tanh")
        return x + self.mm(u, p["w_down"])

    # -- the model ----------------------------------------------------------

    def _layers(self):
        """Each layer's (attention, MLP) weights in float32, read when the
        forward reaches it."""
        b = self.w["blocks"]

        def at(tree, i):
            return {n: t[i].to(self.device, F32) for n, t in tree.items()}
        for i in range(b["attn"]["wq"].shape[0]):
            yield at(b["attn"], i), at(b["mlp"], i)

    def hidden(self, ids: torch.Tensor) -> torch.Tensor:
        """Final-normed hidden states (s, d) of one sequence."""
        x = self.w["embed"][ids.to(self.w["embed"].device).long()].to(
            self.device, F32)
        pos = torch.arange(x.shape[0], device=self.device)
        for pa, pf in self._layers():
            x = self.mlp(pf, self.gqa(pa, x, pos))
        return self.norm(x, self.w["final_norm"].to(self.device, F32))

    def logits_at(self, hid: torch.Tensor, rows: torch.Tensor, block: int
                  = 256):
        """Logits (len(rows), V) in row blocks, yielded block by block."""
        un = self.w["unembed"]
        for r0 in range(0, len(rows), block):
            sel = rows[r0:r0 + block]
            yield sel, self.mm(hid[sel], un.to(self.device, F32))


def served_gaps(ref: Reference, prompt, served: List[int],
                control: Optional[Reference] = None) -> Dict[str, Any]:
    """A request's served tokens judged by the reference.  Returns
    ``tokens`` and, under "program", ``gap``, the widest gap by which
    the reference's logit of a served token lies below its best logit,
    and ``mismatches``, the served tokens that are not the reference's
    best; with ``control`` (the reference in a lower precision) the same
    under "control" for the token the control puts first at the same
    positions."""
    seq = torch.tensor(list(map(int, prompt)) + list(served[:-1]),
                       dtype=torch.long)
    n = len(served)
    rows = torch.arange(len(prompt) - 1, len(prompt) - 1 + n,
                        device=ref.device)
    tok = torch.tensor(served, dtype=torch.long, device=ref.device)
    chid = control.hidden(seq) if control is not None else None
    hid = ref.hidden(seq)
    gap, miss, cgap, cmiss = [], 0, [], 0
    for sel, lg in ref.logits_at(hid, rows):
        t = tok[sel - rows[0]]
        best = lg.max(-1)
        gap.append(best.values - lg.gather(1, t[:, None])[:, 0])
        miss += int((best.indices != t).sum())
        if chid is not None:
            first = next(control.logits_at(chid, sel))[1].argmax(-1)
            cgap.append(best.values - lg.gather(1, first[:, None])[:, 0])
            cmiss += int((best.indices != first).sum())
    out = {"tokens": n, "program": {"gap": float(torch.cat(gap).max()),
                                    "mismatches": miss}}
    if chid is not None:
        out["control"] = {"gap": float(torch.cat(cgap).max()),
                          "mismatches": cmiss}
    return out
