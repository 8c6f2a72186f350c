"""Port parity: the hlslib core constructs.

``repro_torch.core`` against the JAX package's ``repro.core`` on the same
seeded numpy inputs:

* ``treereduce`` — ``tree_reduce`` is BIT-EQUAL in fp32 for Add, Mul, Max
  and Min at lengths that are and are not powers of two, on either axis;
  so are ``serial_reduce`` and ``tree_reduce_fn``.  LogSumExp keeps the
  same pairing but its functor calls exp and log, whose last bits differ
  between XLA's and PyTorch's CPU implementations (measured: up to 4.8e-7
  on sums near 6), so it is held to the JAX test's rtol = 1e-6;
* ``shiftreg`` — the eager register, ``shift_window``, the register-loop
  causal conv with carried state, its oracle, at the JAX tests'
  tolerance (1e-5);
* ``datapack`` — ``DataPack`` packing, typed indexing, ``set`` and the
  elementwise operators (exact), the width checks and padding helpers;
* ``dataflow.run_cyclic_dataflow`` — the software (threaded, bounded
  streams) and sequential (naive) emulations give the JAX package's
  results, so they diverge exactly as there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dataflow as jdf
from repro.core import datapack as jdp
from repro.core import shiftreg as jsr
from repro.core import treereduce as jtr
from repro_torch.core import dataflow as tdf
from repro_torch.core import datapack as tdp
from repro_torch.core import shiftreg as tsr
from repro_torch.core import treereduce as ttr

torch.set_num_threads(2)

EXACT_OPS = ("Add", "Mul", "Max", "Min")
LENGTHS = (1, 2, 3, 5, 37, 100, 128, 300, 1000, 4097)


def _x(seed, shape, op="Add"):
    rng = np.random.default_rng(seed)
    if op == "Mul":     # keep long products finite and normal
        return rng.uniform(0.9, 1.1, shape).astype(np.float32)
    return (rng.standard_normal(shape) * 10).astype(np.float32)


# --- treereduce -----------------------------------------------------------------------


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("op", EXACT_OPS)
def test_tree_reduce_bit_equal(op, n):
    x = _x(n, (3, n), op)
    want = np.asarray(jtr.tree_reduce(jnp.asarray(x), getattr(jtr, op)))
    got = ttr.tree_reduce(torch.from_numpy(x), getattr(ttr, op)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", LENGTHS)
def test_tree_reduce_logsumexp(n):
    x = _x(n, (3, n))
    want = np.asarray(jtr.tree_reduce(jnp.asarray(x), jtr.LogSumExp))
    got = ttr.tree_reduce(torch.from_numpy(x), ttr.LogSumExp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("op", EXACT_OPS)
def test_tree_reduce_axis_bit_equal(op, axis):
    x = _x(7, (37, 300), op)
    want = np.asarray(jtr.tree_reduce(jnp.asarray(x), getattr(jtr, op), axis))
    got = ttr.tree_reduce(torch.from_numpy(x), getattr(ttr, op), axis)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", EXACT_OPS)
def test_serial_reduce_bit_equal(op):
    x = _x(3, (300, 5), op)
    want = np.asarray(jtr.serial_reduce(jnp.asarray(x), getattr(jtr, op), 0))
    got = ttr.serial_reduce(torch.from_numpy(x), getattr(ttr, op), 0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tree_is_deterministically_balanced():
    """int32 addition is associative: tree == sum == serial exactly; the
    fp tree is reproducible run to run and differs from the fold."""
    xi = torch.arange(37, dtype=torch.int32)
    assert int(ttr.tree_reduce(xi, ttr.Add)) == int(xi.sum()) \
        == int(ttr.serial_reduce(xi, ttr.Add))
    xf = torch.from_numpy(_x(0, (1000,)) * 100)
    assert float(ttr.tree_reduce(xf, ttr.Add)) == \
        float(ttr.tree_reduce(xf, ttr.Add))


def test_tree_accuracy_vs_serial():
    rng = np.random.default_rng(42)
    x = (rng.standard_normal(2 ** 14) * 1e4).astype(np.float32)
    exact = float(np.sum(x.astype(np.float64)))
    tree_err = abs(float(ttr.tree_reduce(torch.from_numpy(x))) - exact)
    serial_err = abs(float(ttr.serial_reduce(torch.from_numpy(x))) - exact)
    assert tree_err <= serial_err + 1e-3


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_tree_reduce_fn_matches_reference(n):
    xs = [_x(i, (4,)) for i in range(n)]
    jt = [{"a": jnp.asarray(x), "b": [jnp.asarray(2 * x)]} for x in xs]
    tt = [{"a": torch.from_numpy(x), "b": [torch.from_numpy(2 * x)]}
          for x in xs]
    want = jtr.tree_reduce_fn(jt, jtr.Add)
    got = ttr.tree_reduce_fn(tt, ttr.Add)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"][0].numpy(),
                                  np.asarray(want["b"][0]))


def test_empty_rejected():
    with pytest.raises(ValueError):
        ttr.tree_reduce(torch.zeros((3, 0)), ttr.Add)
    with pytest.raises(ValueError):
        ttr.tree_reduce_fn([], ttr.Add)


# --- shiftreg -------------------------------------------------------------------------


def test_shiftreg_taps_segments_and_checks():
    N = 8
    r = tsr.ShiftReg(2 * N + 1, taps=[0, 1, 2 * N - 1, 2 * N])
    assert r.segment_sizes == jsr.ShiftReg(
        2 * N + 1, taps=[0, 1, 2 * N - 1, 2 * N]).segment_sizes
    for bad in ([3, 0], [0, 9], [1, 1]):
        with pytest.raises(ValueError):
            tsr.ShiftReg(8, taps=bad)
    r, j = tsr.ShiftReg(4, taps=[0, 3]), jsr.ShiftReg(4, taps=[0, 3])
    for i in range(10):
        r.Shift(i)
        j.Shift(i)
        assert (r[0], r[3]) == (j[0], j[3])
    assert r[0] == 9 and r[3] == 6
    with pytest.raises(KeyError):
        r.Get(1)


@pytest.mark.parametrize("window", [1, 3, 6])
def test_shift_window_matches_reference(window):
    x = _x(window, (10, 3))
    want = np.asarray(jsr.shift_window(jnp.asarray(x), window, fill=-1.0))
    got = tsr.shift_window(torch.from_numpy(x), window, fill=-1.0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,c,t", [(2, 1, 1), (4, 3, 20), (6, 5, 40),
                                   (3, 2, 7)])
def test_causal_conv_matches_reference(k, c, t):
    x, w = _x(k * 100 + t, (t, c)), _x(c, (k, c))
    jy, jst = jsr.causal_conv_shiftreg(jnp.asarray(x), jnp.asarray(w))
    ty, tst = tsr.causal_conv_shiftreg(torch.from_numpy(x),
                                       torch.from_numpy(w))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_allclose(
        tsr.causal_conv_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jsr.causal_conv_ref(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)


def test_conv_state_continuation():
    """Streaming with the register carried across == one pass over the
    concatenation, as in the reference (tests/test_shiftreg.py)."""
    x, w = torch.from_numpy(_x(0, (20, 3))), torch.from_numpy(_x(1, (4, 3)))
    full, _ = tsr.causal_conv_shiftreg(x, w)
    y1, st1 = tsr.causal_conv_shiftreg(x[:12], w)
    y2, _ = tsr.causal_conv_shiftreg(x[12:], w, state=st1)
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
    _, jst1 = jsr.causal_conv_shiftreg(jnp.asarray(x[:12].numpy()),
                                       jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(st1.numpy(), np.asarray(jst1))


def test_sliding_window_indices():
    for t, win in ((0, 4), (3, 4), (10, 4), (10, 1)):
        np.testing.assert_array_equal(tsr.sliding_window_indices(t, win),
                                      jsr.sliding_window_indices(t, win))


# --- datapack -------------------------------------------------------------------------


def test_datapack_constants_and_helpers():
    assert tdp.LANE == jdp.LANE == 128
    for n in (1, 127, 128, 129, 50_280):
        assert tdp.pad_to_lanes(n) == jdp.pad_to_lanes(n)
        assert tdp.padded_vocab(n) == jdp.padded_vocab(n)
        assert tdp.padding_waste(n, tdp.pad_to_lanes(n)) == \
            jdp.padding_waste(n, jdp.pad_to_lanes(n))
    tdp.assert_lane_aligned(256, 512)
    with pytest.raises(ValueError):
        tdp.assert_lane_aligned(130)
    with pytest.raises(ValueError):
        tdp.DataPack.pack(torch.zeros(8), width=100)


@pytest.mark.parametrize("n,width", [(1, 128), (100, 128), (128, 128),
                                     (300, 256), (700, 128)])
def test_datapack_pack_unpack_matches_reference(n, width):
    x = _x(n, (2, n))
    j = jdp.DataPack.pack(jnp.asarray(x), width=width)
    t = tdp.DataPack.pack(torch.from_numpy(x), width=width)
    assert (t.width, t.groups, t.logical) == (j.width, j.groups, j.logical)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t.unpack().numpy(), x)


def test_datapack_indexing_set_and_elementwise():
    x = _x(5, (256,))
    j = jdp.DataPack.pack(jnp.asarray(x), 128)
    t = tdp.DataPack.pack(torch.from_numpy(x), 128)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    for jr, tr in (((j + j) * 2.0, (t + t) * 2.0), (j - j / 3.0, t - t / 3.0),
                   (3.0 * j + 1.0, 3.0 * t + 1.0), (1.0 + j, 1.0 + t)):
        np.testing.assert_array_equal(tr.unpack().numpy(),
                                      np.asarray(jr.unpack()))
    r = t.set(1, torch.zeros(128))
    assert float(r[1].sum()) == 0.0
    np.testing.assert_array_equal(t[1].numpy(), x[128:])   # t unchanged
    with pytest.raises(ValueError):
        _ = t + tdp.DataPack.pack(torch.zeros(256), 256)


# --- cyclic dataflow ------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["software", "sequential"])
@pytest.mark.parametrize("fn,T,N", [("inc", 5, 16), ("dbl", 3, 8),
                                    ("inc", 1, 4)])
def test_cyclic_dataflow_matches_reference(mode, fn, T, N):
    f = (lambda v: v + 1) if fn == "inc" else (lambda v: 2 * v)
    jm, tm = list(range(N)), list(range(N))
    jdf.run_cyclic_dataflow(jm, f, T=T, N=N, mode=mode)
    tdf.run_cyclic_dataflow(tm, f, T=T, N=N, mode=mode)
    assert tm == jm
    applied = T if mode == "software" else 1
    want = [v + applied for v in range(N)] if fn == "inc" else \
        [v * 2 ** applied for v in range(N)]
    assert tm == want


def test_cyclic_dataflow_on_a_tensor_diverges():
    """The same program on tensor memory: software mode sees the previous
    iteration's writes, sequential mode stale memory."""
    m1 = torch.arange(8, dtype=torch.float32)
    m2 = m1.clone()
    tdf.run_cyclic_dataflow(m1, lambda v: 2 * v, T=3, N=8, mode="software")
    tdf.run_cyclic_dataflow(m2, lambda v: 2 * v, T=3, N=8,
                            mode="sequential")
    assert torch.equal(m1, torch.arange(8.0) * 8)
    assert torch.equal(m2, torch.arange(8.0) * 2)
