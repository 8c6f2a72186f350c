"""Operation and byte counts of a callable: the port's counterpart of
the reference's ``roofline/hlo_walk.py``.

The reference walks XLA's optimized HLO.  Eager PyTorch has no such
program, so ``Counter`` (a ``TorchDispatchMode``) sees every aten op as
it runs -- on fake tensors (``FakeTensorMode``: shapes, dtypes and no
storage, so a full-size cell costs no memory) or on real ones -- and
counts:

* FLOPs of the products (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  convolutions) with the formulas of ``torch.utils.flop_counter``
  (``FlopCounterMode``'s registry): 2 x |result| x |contracted dims|;
* bytes by the reference's model (``hlo_walk.py``): products,
  reductions, gathers, scatters, index ops, concatenations and copies
  read each operand once and write each result once; an in-place
  scatter or slice write moves twice its update, not the buffer it
  writes into (the reference's ``dynamic-update-slice``); pure
  elementwise ops (dtype conversions, pads and fills included) are free;
  views, reshapes and factories are free;
* the largest single allocation (the largest result of an op that is
  not a view);
* per-scope attribution: each op is charged to the innermost functions
  of this package on the Python stack (``by_scope_flops`` /
  ``by_scope_bytes``; ``top_scopes`` ranks them as the reference's
  does).

The byte model describes a *fused* implementation -- the traffic of a
program whose elementwise chains live in registers between products and
reductions, as XLA's fusions and the reference's walker assume -- not
the eager port's real traffic, in which every elementwise op reads and
writes memory.  ``coll`` stays 0: one device runs no collective.

Some functions are counted by formula instead (``by_formula``): loops
too long to trace op by op (the blocked attention of
``models/layers.py``, the chunked SSD scan of ``kernels/ref.py``) and
the decode-attention and KV-quantization kernel wrappers (a kernel
launched through ctypes is not an aten op, so the card's runs enter by
the same formula as the CPU's).  While a counter is active
(``counting()``) such a function records its work from the shapes (and,
on real tensors, the positions); on real tensors it then runs with
counting suspended and returns what it always returns, and on fake
tensors, which hold no data, it may skip its body and return
stand-ins of its outputs' shapes.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import os
import sys
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# pure elementwise ops beyond those tagged ``pointwise`` (fused away, as
# the reference's ``_ELEMENTWISE``), and free ops (views, factories,
# host reads; the reference's ``_FREE_OPS``).
_ELEMENTWISE = {
    "_to_copy", "constant_pad_nd", "fill_", "fill", "zero_", "masked_fill",
    "masked_fill_", "where", "clamp", "clamp_", "clamp_min", "clamp_max",
    "lerp", "lerp_", "addcmul", "addcmul_", "addcdiv", "addcdiv_",
    "bernoulli_", "uniform_", "normal_", "rand", "randn", "rand_like",
    "randn_like", "exponential_", "_softmax_backward_data",
    "threshold_backward", "silu_backward", "gelu_backward",
    "sigmoid_backward", "tanh_backward", "repeat", "roll", "flip",
    "tril", "triu", "one_hot",
}
_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "new_zeros", "new_ones", "new_full", "arange", "scalar_tensor",
    "lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "detach",
    "alias", "_unsafe_view", "resize_", "set_", "record_stream",
}
# in-place writes of an update into a buffer: twice the update (the
# reference's in-place ``dynamic-update-slice``).
_UPDATES = {"index_put_", "index_copy_", "scatter_", "scatter_add_",
            "index_add_", "copy_", "_index_put_impl_", "masked_scatter_",
            "slice_scatter", "select_scatter"}


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return 0


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def op_bytes(func, args, kwargs, out) -> float:
    """HBM bytes of one aten op under the reference's model."""
    name = func.overloadpacket.__name__
    if func.is_view or name in _FREE or name in _ELEMENTWISE \
            or torch.Tag.pointwise in func.tags:
        if name == "_to_copy":
            dev = kwargs.get("device")
            src = args[0]
            if dev is not None and torch.device(dev) != src.device:
                return 2.0 * _nbytes(src)          # a copy across devices
        return 0.0
    if name in _UPDATES:
        srcs = _tensors(list(args[1:]) + list(kwargs.values()))
        return sum((2.0 if t.is_floating_point() else 1.0) * _nbytes(t)
                   for t in srcs)
    if name in ("cat", "stack"):
        return 2.0 * sum(_nbytes(t) for t in _tensors(out))
    ins = _tensors(list(args) + list(kwargs.values()))
    return float(sum(map(_nbytes, ins)) + sum(map(_nbytes, _tensors(out))))


def op_flops(func, args, kwargs, out) -> float:
    f = flop_registry.get(func.overloadpacket)
    return float(f(*args, **kwargs, out_val=out)) if f is not None else 0.0


_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)


def _scope(depth: int = 4) -> str:
    """The innermost ``depth`` functions of this package on the stack,
    outer to inner (``transformer.forward/layers.attention_apply``)."""
    parts: List[str] = []
    f = sys._getframe(2)
    while f is not None and len(parts) < depth:
        code = f.f_code
        fn = code.co_filename
        if fn.startswith(_PKG) and not fn.startswith(_HERE):
            mod = os.path.splitext(os.path.basename(fn))[0]
            parts.append(f"{mod}.{code.co_name}")
        f = f.f_back
    return "/".join(reversed(parts)) if parts else "(unattributed)"


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"total": 0.0})
    largest_alloc: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    by_scope_flops: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    by_scope_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    ops: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))


# the counters that count by formula, innermost last (per thread, as
# torch's own dispatch-mode stack).
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("counters",
                                                         default=())


class Counter(TorchDispatchMode):
    """Counts what runs under it (see the module docstring); ``costs``
    holds the totals.  ``scopes=False`` skips the per-scope attribution
    (a stack walk per op).  ``by_formula=False`` leaves the loops counted
    by formula to run op by op (it does not set ``counting()``): the
    counter then records what the code really computes and allocates."""

    def __init__(self, scopes: bool = True, by_formula: bool = True):
        super().__init__()
        self.costs = Costs()
        self.scopes = scopes
        self.by_formula = by_formula
        self._suspended = 0

    def __enter__(self):
        if self.by_formula:
            self._token = _ACTIVE.set(_ACTIVE.get() + (self,))
        return super().__enter__()

    def __exit__(self, *exc):
        if self.by_formula:
            _ACTIVE.reset(self._token)
        return super().__exit__(*exc)

    def add(self, flops: float, nbytes: float, name: str) -> None:
        c = self.costs
        c.flops += flops
        c.bytes += nbytes
        c.ops[name] += 1
        if self.scopes and (flops or nbytes):
            s = _scope()
            c.by_scope_flops[s] += flops
            c.by_scope_bytes[s] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suspended or func.namespace != "aten":
            return out                   # prim.device and the like: free
        name = str(func.overloadpacket)
        if not func.is_view:
            big = max(map(_nbytes, _tensors(out)), default=0)
            if big > self.costs.largest_alloc and \
                    func.overloadpacket.__name__ not in _UPDATES:
                self.costs.largest_alloc = big
        self.add(op_flops(func, args, kwargs, out),
                 op_bytes(func, args, kwargs, out), name)
        return out


def counting() -> Optional[Counter]:
    """The innermost counter that counts by formula, or None."""
    active = _ACTIVE.get()
    return active[-1] if active else None


def record(name: str, flops: float, nbytes: float,
           alloc: int = 0) -> None:
    """Add work counted by formula to the active counter (if any), under
    the caller's scope; ``alloc``: the largest tensor the formula's
    implementation allocates at once."""
    c = counting()
    if c is not None and not c._suspended:
        c.add(float(flops), float(nbytes), name)
        c.costs.largest_alloc = max(c.costs.largest_alloc, int(alloc))


@contextlib.contextmanager
def suspended():
    """Run the body uncounted (work already recorded by formula)."""
    c = counting()
    if c is None:
        yield
        return
    c._suspended += 1
    try:
        yield
    finally:
        c._suspended -= 1


class _Backward(torch.autograd.Function):
    """Joins the stand-ins of a function skipped on fake tensors to its
    inputs, and records the function's backward work by formula when
    autograd gets there (zero gradients: the graph around it stays
    whole)."""

    @staticmethod
    def forward(ctx, name, work, outs, *inputs):
        ctx.name, ctx.work, ctx.inputs = name, work, inputs
        if isinstance(outs, tuple):
            return tuple(t.clone() for t in outs)
        return outs.clone()

    @staticmethod
    def backward(ctx, *grads):
        record(ctx.name + "_backward", *ctx.work)
        return (None, None, None) + tuple(map(torch.zeros_like, ctx.inputs))


def by_formula(work: Callable, fake: Optional[Callable] = None,
               backward: Optional[Callable] = None):
    """Decorator: count a function by formula.  Under a counter,
    ``work(*args, **kwargs)`` -> (FLOPs, bytes[, largest allocation]) is
    recorded under the function's name; on real tensors the function
    then runs with counting suspended (a kernel launch is no aten op; a
    plain twin's ops would count twice).  On fake tensors ``fake(*args,
    **kwargs)`` (if given) stands in for the result and the body is
    skipped (it may be too long a loop, or need data); ``backward(*args,
    **kwargs)`` -> (FLOPs, bytes) is then recorded when autograd takes
    the stand-ins' gradients.  Without a counter the function runs
    untouched."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            c = counting()
            if c is None or c._suspended:
                return fn(*args, **kwargs)
            with suspended():
                w = work(*args, **kwargs)
            record(fn.__name__, *w)
            ins = _tensors([args, kwargs])
            with suspended():
                if fake is None or not any(map(is_fake, ins)):
                    return fn(*args, **kwargs)
                outs = fake(*args, **kwargs)
                if backward is not None and torch.is_grad_enabled() and \
                        any(t.requires_grad for t in ins):
                    outs = _Backward.apply(fn.__name__,
                                           backward(*args, **kwargs), outs,
                                           *ins)
                return outs
        return wrapped
    return deco


def is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor) or t.device.type == "meta"


def _unique_bytes(tree, skip=()) -> int:
    seen = {id(t) for t in skip}
    n = 0
    for t in _tensors(tree):
        if id(t) not in seen:
            seen.add(id(t))
            n += _nbytes(t)
    return n


def count(fn: Callable, *args, scopes: bool = True, **kwargs
          ) -> Tuple[object, Costs]:
    """Run ``fn(*args, **kwargs)`` under a ``Counter``: (result, costs),
    with the bytes of the arguments and of the outputs that are not
    arguments written in place (the reference's ``memory_analysis``
    terms)."""
    with Counter(scopes=scopes) as c:
        out = fn(*args, **kwargs)
    c.costs.argument_bytes = _unique_bytes([args, kwargs])
    c.costs.output_bytes = _unique_bytes(
        out, skip=_tensors([args, kwargs]))
    return out, c.costs


def fake_mode():
    """A ``FakeTensorMode`` for counting: tensors made inside it have
    shapes, dtypes and a device (the CPU) but no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=False)


def top_scopes(d: Dict[str, float], k: int = 12) -> List[Tuple[str, float]]:
    return sorted(d.items(), key=lambda kv: -kv[1])[:k]


# --- work by formula ----------------------------------------------------------------


def blocked_tiles(sq: int, sk: int, causal: bool, window, block_q: int,
                  block_k: int, block_skip: bool) -> Tuple[int, int, int]:
    """(tiles visited, block_q, block_k) of the blocked attention on
    these lengths: every tile, or with ``block_skip`` the causally live
    band, padding included (``layers._ki_range``)."""
    from ..models.layers import _ki_range
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    nq, nk = -(-sq // block_q), -(-sk // block_k)
    q_off = sk - sq
    n = 0
    for qi in range(nq):
        lo, hi = _ki_range(qi, nk, causal, window, block_q, block_k, q_off,
                           block_skip)
        n += max(hi - lo, 0)
    return n, block_q, block_k


def _blocked_attention_tiles(q, k, v, causal, window, block_q, block_k,
                             block_skip):
    """(tiles visited, per-tile bytes of q, k, v, scores and output at
    fp32 (the tiles' dtype) and the scores of the most rows one kv block
    meets at once (the forward's largest allocation), per-tile FLOPs of
    Q·Kᵀ and P·V)."""
    from ..models.layers import _qi_range
    b, hq, sq, d = q.shape
    hkv, sk, dv = v.shape[1], v.shape[2], v.shape[3]
    n, bq, bk = blocked_tiles(sq, sk, causal, window, block_q, block_k,
                              block_skip)
    nq, nk = -(-sq // bq), -(-sk // bk)
    rows = max(max(hi - lo, 0) for lo, hi in (
        _qi_range(ki, nq, causal, window, bq, bk, sk - sq, block_skip)
        for ki in range(nk))) * bq
    f4 = 4
    t = dict(q=b * hq * bq * d * f4, k=b * hkv * bk * d * f4,
             v=b * hkv * bk * dv * f4, s=b * hq * bq * bk * f4,
             o=b * hq * bq * dv * f4, col=b * hq * bq * f4,
             step=b * hq * rows * bk * f4)
    return n, t, 2.0 * b * hq * bq * bk * d, 2.0 * b * hq * bq * bk * dv


def blocked_attention_work(q, k, v, causal, window, scale, block_q, block_k,
                           block_skip, p_bf16=False):
    """The blocked attention forward's work from its shapes (the
    signature of ``layers._attention_blocked_fwd``): per visited tile the
    score product S = Q·Kᵀ and the PV product; bytes per tile by the
    model above: each product reads its operands and writes its result,
    the row max and row sum read the scores and write a column.  Returns
    (FLOPs, bytes, the scores of one kv step: the largest allocation)."""
    n, t, qk, pv = _blocked_attention_tiles(q, k, v, causal, window,
                                            block_q, block_k, block_skip)
    nbytes = n * ((t["q"] + t["k"] + t["s"]) + 2 * (t["s"] + t["col"])
                  + (t["s"] + t["v"] + t["o"]))
    return n * (qk + pv), nbytes, t["step"]


def blocked_attention_bwd_work(q, k, v, out, lse, do, causal, window, scale,
                               block_q, block_k, block_skip):
    """The backward's work (the signature of
    ``layers._attention_blocked_bwd``, the reference's custom VJP): pass 1
    recomputes S and takes dP = dO·Vᵀ and dQ += dS·K, pass 2 recomputes S
    and takes dV += Pᵀ·dO, dP again and dK += dSᵀ·Q."""
    n, t, qk, pv = _blocked_attention_tiles(q, k, v, causal, window,
                                            block_q, block_k, block_skip)
    flops = n * (2 * qk + 2 * pv + qk + pv + qk)
    nbytes = n * (2 * (t["q"] + t["k"] + t["s"])
                  + 2 * (t["o"] + t["v"] + t["s"])
                  + (t["s"] + t["k"] + t["q"]) + (t["s"] + t["o"] + t["v"])
                  + (t["s"] + t["q"] + t["k"]))
    return flops, nbytes, t["s"]


def decode_attention_work(q, keys: int, kv_row_bytes: float,
                          dv: Optional[int] = None) -> Tuple[float, float]:
    """(FLOPs, bytes) of decode or verify attention over ``keys`` live
    keys summed over the sequences, each key of ``kv_row_bytes`` (K and V
    of every kv head, scales included): QKᵀ and PV, 2·hq·sq·(d + dv) per
    key; q and the output once, each live K/V row once."""
    b, hq, sq, d = q.shape
    dv = d if dv is None else dv
    flops = 2.0 * hq * sq * keys * (d + dv)
    return flops, 2.0 * _nbytes(q) + keys * kv_row_bytes
