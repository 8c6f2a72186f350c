"""Port parity: the hlslib host runtime on one device.

``repro_torch.core`` against the JAX package's ``repro.core``:

* ``context`` — the five tests of ``tests/test_context.py`` on the port,
  ``device="cpu"``.  The reference's introspection test reads XLA's HLO
  text; the port compiles nothing (PyTorch runs eagerly), so its twin
  checks the bound kernel's name and result, and HLO-style introspection
  waits for the roofline slice.  ``Context()`` defaults to the card;
* ``pipeline`` — ``fused_pipeline`` equals the JAX ``fused_pipeline`` on
  the same seeded numpy microbatches (fp32, to 1e-6: the stages' matmul
  sums in another order), and ``pipeline_efficiency`` is M / (M + S - 1);
* ``health`` — ``Heartbeat`` under a fake clock and a seeded sequence of
  ``StragglerDetector.observe`` verdicts equal the JAX package's exactly
  (both are host Python);
* the quickstart twin prints the JAX example's values (F7 to 1e-5).
"""

import io
import contextlib
import pathlib
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import context as jcontext
from repro.core import health as jhealth
from repro.core import pipeline as jpipe
from repro.core.stream import stream_all as jstream_all
from repro_torch.core import (Access, Context, Heartbeat, MemoryBank,
                              StragglerDetector, stream_all)
from repro_torch.core import pipeline as tpipe
from repro_torch.examples import quickstart as tquick

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_listing2_flow():
    """The paper's host program, verbatim shape: context -> program ->
    buffers -> kernel -> execute -> copy back."""
    N = 1024
    context = Context("cpu")
    program = context.MakeProgram(
        {"Kernel": lambda a, b, n: (a * 2.0 + b, n)})
    input_host = np.full(N, 5.0, np.float32)
    in_dev = context.MakeBuffer(torch.float32, Access.read,
                                MemoryBank.bank0, input_host)
    out_dev = context.MakeBuffer(torch.float32, Access.write,
                                 MemoryBank.bank1, N)
    kernel = program.MakeKernel("Kernel", in_dev, out_dev, N)
    result, n = kernel.ExecuteTask()
    assert n == N
    host = np.empty(N, np.float32)
    np.copyto(host, result.numpy())
    np.testing.assert_allclose(host, 10.0)
    assert out_dev.CopyToHost(np.empty(N, np.float32)).sum() == 0


def test_buffer_access_modes():
    ctx = Context("cpu")
    b = ctx.MakeBuffer(torch.float32, Access.read, MemoryBank.bank0,
                       np.ones(4, np.float32))
    with pytest.raises(PermissionError):
        b.CopyFromHost(np.zeros(4, np.float32))
    w = ctx.MakeBuffer(torch.float32, Access.write, MemoryBank.bank0, 4)
    w.CopyFromHost(np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(w.CopyToHost(), np.arange(4))
    assert w.shape == (4,) and w.dtype == torch.float32


def test_kernel_introspection():
    """The bound kernel keeps its name and arguments and computes the
    product; its introspection (the reference reads XLA's HLO here) comes
    from the roofline counter: the dispatched aten ops, 2·64³ FLOPs."""
    ctx = Context("cpu")
    prog = ctx.MakeProgram({"mm": lambda a, b: a @ b})
    a = ctx.MakeBuffer(torch.float32, Access.read, MemoryBank.bank0,
                       np.ones((64, 64), np.float32))
    k = prog.MakeKernel("mm", a, a)
    assert k.name == "mm" and k.args == (a, a)
    assert "aten.mm" in k.hlo_text()
    assert k.cost_analysis()["flops"] == 2 * 64 ** 3
    out = k.ExecuteTask()
    np.testing.assert_allclose(out.numpy(), 64.0)


def test_unknown_kernel_rejected():
    ctx = Context("cpu")
    prog = ctx.MakeProgram({"f": lambda x: x})
    with pytest.raises(KeyError):
        prog.MakeKernel("nope", 1)


def test_async_execution():
    ctx = Context("cpu")
    prog = ctx.MakeProgram({"f": lambda x: x + 1})
    b = ctx.MakeBuffer(torch.float32, Access.read_write, MemoryBank.bank0,
                       np.zeros(8, np.float32))
    k = prog.MakeKernel("f", b)
    fut = k.ExecuteAsync()
    np.testing.assert_allclose(fut.numpy(), 1.0)
    # arguments given at execution override the bound ones.
    np.testing.assert_allclose(k.ExecuteTask(torch.ones(3)).numpy(), 2.0)


def test_context_defaults_to_the_card_and_sharding_waits():
    """The context defaults to the card; ``MemoryBank.sharded`` names its
    mesh axes and, on a context of one device, places the whole buffer
    there (placement over a mesh: ``tests/test_torch_collectives.py``)."""
    assert Context().device.type == "cuda"
    assert Context("cpu").device.type == "cpu"
    assert MemoryBank.bank0 != MemoryBank.bank1
    bank = MemoryBank.sharded("data", None)
    assert bank.spec == ("data", None) and bank != MemoryBank.bank0
    data = np.arange(12, dtype=np.float32).reshape(4, 3)
    buf = Context("cpu").MakeBuffer(torch.float32, Access.read_write, bank,
                                    data)
    assert type(buf.tensor) is torch.Tensor
    np.testing.assert_array_equal(buf.CopyToHost(), data)
    with pytest.raises(TypeError):
        Context("cpu").MakeBuffer(torch.float32, Access.read,
                                  MemoryBank.bank0, "x")


def test_stream_all():
    """``tests/test_stream.py::test_stream_all`` on the port, and the
    pre-loaded stream's depth grows to hold its values, as the
    reference's does."""
    s = stream_all([1, 2, 3])
    assert [s.Pop() for _ in range(3)] == [1, 2, 3]
    for vals, depth in (([1, 2, 3], 2), ([], 2), (list(range(9)), 16)):
        t, j = stream_all(vals, depth=depth), jstream_all(vals, depth=depth)
        assert (t.depth, t.Size()) == (j.depth, j.Size())


@pytest.mark.parametrize("src", [
    np.asarray([7.0], np.float32),               # (1,) into a (4,) buffer
    np.arange(6, dtype=np.int32).reshape(2, 3),  # int into a float buffer
    np.asarray([1.5, -2.0, 3.25, 0.0], np.float32),
])
def test_copy_from_host_rebinds_like_the_reference(src):
    """``CopyFromHost`` takes the host array's shape and dtype (the
    reference's ``device_put`` rebinding): no broadcast of a (1,) array
    over the buffer, no cast of ints to the buffer's float dtype, and a
    kernel bound to the buffer sees the new data."""
    jctx = jcontext.Context()
    jb = jctx.MakeBuffer(jnp.float32, jcontext.Access.write,
                         jcontext.MemoryBank.bank0, 4).CopyFromHost(src)
    b = Context("cpu").MakeBuffer(torch.float32, Access.write,
                                  MemoryBank.bank0, 4)
    k = b.ctx.MakeProgram({"twice": lambda x: x * 2}).MakeKernel("twice", b)
    assert b.CopyFromHost(src) is b
    want = np.array(jb.CopyToHost())
    assert b.shape == tuple(jb.shape) == src.shape
    assert str(b.CopyToHost().dtype) == str(want.dtype) == str(src.dtype)
    np.testing.assert_array_equal(b.CopyToHost(), want)
    np.testing.assert_array_equal(k.ExecuteTask().numpy(), src * 2)
    src[...] = 0                                 # the buffer holds a copy
    np.testing.assert_array_equal(b.CopyToHost(), want)


def test_replicated_bank_and_donate_keyword():
    """``MemoryBank.replicated()`` is the one-device bank; ``MakeKernel``
    takes the reference's ``donate=`` and ignores it (eager torch has no
    buffer donation), so the donated buffer stays readable."""
    assert MemoryBank.replicated() == MemoryBank.bank0
    assert jcontext.MemoryBank.replicated() == jcontext.MemoryBank.bank0
    ctx = Context("cpu")
    b = ctx.MakeBuffer(torch.float32, Access.read_write,
                       MemoryBank.replicated(), np.arange(4, dtype=np.float32))
    prog = ctx.MakeProgram({"inc": lambda x: x + 1})
    k = prog.MakeKernel("inc", b, donate=(0,))
    np.testing.assert_array_equal(k.ExecuteTask().numpy(), np.arange(1, 5))
    np.testing.assert_array_equal(b.CopyToHost(), np.arange(4))
    jk = jcontext.Context().MakeProgram({"inc": lambda x: x + 1}).MakeKernel(
        "inc", jnp.arange(4, dtype=jnp.float32), donate=())
    np.testing.assert_array_equal(np.asarray(jk.ExecuteTask()),
                                  k.ExecuteTask().numpy())


@pytest.mark.parametrize("n_micro,n_stages", [(6, 4), (1, 3), (8, 1)])
def test_fused_pipeline_matches_jax(n_micro, n_stages):
    rng = np.random.default_rng(n_micro * 10 + n_stages)
    xs = rng.standard_normal((n_micro, 4, 16)).astype(np.float32)
    ws = [rng.standard_normal((16, 16)).astype(np.float32) * 0.25
          for _ in range(n_stages)]

    def stages(lib, wrap):
        return [lambda x, w=wrap(w): lib.tanh(x @ w) * 1.5 + 0.25
                for w in ws]

    want = np.asarray(jpipe.fused_pipeline(stages(jnp, jnp.asarray),
                                           jnp.asarray(xs)))
    got = tpipe.fused_pipeline(stages(torch, torch.from_numpy),
                               torch.from_numpy(xs))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the same as composing the stages by hand on each microbatch.
    seq = xs
    for f in stages(np, lambda w: w):
        seq = np.stack([f(x) for x in seq])
    np.testing.assert_allclose(got.numpy(), seq, rtol=1e-5, atol=1e-5)
    assert tpipe.pipeline_efficiency(n_micro, n_stages) == \
        jpipe.pipeline_efficiency(n_micro, n_stages)


def test_pipeline_efficiency():
    assert tpipe.pipeline_efficiency(6, 4) == 6 / 9
    assert tpipe.pipeline_efficiency(1, 1) == 1.0


def test_heartbeat_under_a_fake_clock_matches_jax():
    def run(cls):
        now = [0.0]
        hb = cls(["a", "b", "c"], timeout=2.0, clock=lambda: now[0])
        seen = []
        for t, who in ((0.5, "a"), (1.0, "b"), (2.5, "a"), (3.1, None),
                       (3.5, "c"), (4.6, None), (7.0, "b"), (9.9, None)):
            now[0] = t
            if who:
                hb.beat(who)
            seen.append((hb.dead(), hb.alive(), hb.dead(now=t + 1.5)))
        return seen

    assert run(Heartbeat) == run(jhealth.Heartbeat)


def test_straggler_verdicts_match_jax():
    rng = np.random.default_rng(7)
    dts = 0.1 + 0.01 * rng.standard_normal(200)
    dts[rng.choice(200, 12, replace=False)] *= rng.uniform(1.2, 4.0, 12)
    dts[:3] = 0.01                               # sub-jitter warm-up
    for kw in ({}, {"alpha": 0.5, "z": 2.0, "warmup": 2, "min_dt": 0.0}):
        t, j = StragglerDetector(**kw), jhealth.StragglerDetector(**kw)
        got = [t.observe(float(d)) for d in dts]
        want = [j.observe(float(d)) for d in dts]
        assert got == want and any(got)
        assert (t.mean, t.var, t.n) == (j.mean, j.var, j.n)


def test_quickstart_matches_the_jax_example():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                       run_name="__main__")
    want = buf.getvalue().strip().splitlines()
    got = tquick.run("cpu")
    assert len(got) == len(want) == 5
    assert got[:4] == want[:4]
    g7 = [float(s) for s in got[4].split(":")[1].split("vs")[0].split()]
    w7 = [float(s) for s in want[4].split(":")[1].split("vs")[0].split()]
    np.testing.assert_allclose(g7, w7, rtol=1e-5)
    assert float(got[4].rsplit(":", 1)[1]) == pytest.approx(
        float(want[4].rsplit(":", 1)[1]), rel=1e-5)
