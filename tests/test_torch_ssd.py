"""Port parity: the Mamba2 SSD scan, its oracles and kernel B6's twin.

The same numpy-made inputs (the JAX tests' scales: x, B and C x 0.5,
dt ~ U(0.1, 0.5), A = -U(0.5, 1.5)) go through both packages:

* ``ref.ssd_recurrence_ref`` and ``ref.ssd_chunked_ref`` against the JAX
  oracles, with an incoming state, a ragged tail (``s % chunk != 0``,
  zero-dt padding) and state continuation across two calls;
* ``ssd_scan`` on CPU tensors (its plain twin, what the CUDA kernel is
  held against on the card) against the JAX Pallas kernel in interpret
  mode at the three shapes of ``tests/test_kernels.py``;
* ``ops.ssd`` against the JAX ``ops.ssd`` on both branches.

Tolerance: rtol = atol = 2e-4, the JAX tests' own (fp32, sums in other
orders over up to 256 positions and several chunks); the port's oracles
against JAX's land far inside it (~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jscan
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

torch.set_num_threads(2)

TOL = 2e-4


def _inputs(seed, b, s, h, dh, ds):
    """(x, dt, A, B, C) as numpy fp32; b None for one unbatched sequence."""
    rng = np.random.default_rng(seed)
    lead = (s,) if b is None else (b, s)
    x = (rng.standard_normal(lead + (h, dh)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.1, 0.5, lead + (h,)).astype(np.float32)
    A = -rng.uniform(0.5, 1.5, (h,)).astype(np.float32)
    B = (rng.standard_normal(lead + (ds,)) * 0.5).astype(np.float32)
    C = (rng.standard_normal(lead + (ds,)) * 0.5).astype(np.float32)
    return x, dt, A, B, C


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_recurrence_matches_jax_with_incoming_state():
    arrs = _inputs(1, None, 40, 3, 16, 8)
    st = (np.random.default_rng(2).standard_normal((3, 8, 16)) * 0.5
          ).astype(np.float32)
    jy, js = jref.ssd_recurrence_ref(*_j(arrs), state=jnp.asarray(st))
    ty, ts = ref.ssd_recurrence_ref(*_t(arrs), state=torch.from_numpy(st))
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("s,chunk", [(64, 16), (50, 16), (37, 8), (5, 8)])
def test_chunked_matches_jax_including_ragged_tails(s, chunk):
    """s % chunk != 0 pads with zero dt (an exact no-op on the state)."""
    arrs = _inputs(s, None, s, 2, 16, 8)
    st = (np.random.default_rng(3).standard_normal((2, 8, 16)) * 0.5
          ).astype(np.float32)
    jy, js = jref.ssd_chunked_ref(*_j(arrs), chunk=chunk,
                                  state=jnp.asarray(st))
    ty, ts = ref.ssd_chunked_ref(*_t(arrs), chunk=chunk,
                                 state=torch.from_numpy(st))
    assert ty.shape == (s, 2, 16) and ts.shape == (2, 8, 16)
    _close(ty, jy)
    _close(ts, js)
    # the chunked form equals the port's own recurrence (the duality).
    ry, rs = ref.ssd_recurrence_ref(*_t(arrs), state=torch.from_numpy(st))
    _close(ty, ry.numpy())
    _close(ts, rs.numpy())


def test_state_continuation():
    """Two calls, the second fed the first's final state, give one call's
    outputs and final state (prefill then decode rely on it)."""
    x, dt, A, B, C = _t(_inputs(4, None, 64, 2, 16, 8))
    y_full, st_full = ref.ssd_chunked_ref(x, dt, A, B, C, chunk=16)
    y1, st1 = ref.ssd_chunked_ref(x[:32], dt[:32], A, B[:32], C[:32], 16)
    y2, st2 = ref.ssd_chunked_ref(x[32:], dt[32:], A, B[32:], C[32:], 16,
                                  state=st1)
    _close(torch.cat([y1, y2]), y_full.numpy())
    _close(st2, st_full.numpy())


@pytest.mark.parametrize("b,s,h,dh,ds,chunk", [
    (1, 64, 2, 32, 16, 16),
    (2, 128, 3, 64, 32, 32),
    (1, 256, 1, 64, 128, 64),   # mamba2-1.3b-like ratios
])
def test_kernel_twin_matches_jax_pallas_kernel(b, s, h, dh, ds, chunk):
    arrs = _inputs(s + h, b, s, h, dh, ds)
    want = jscan(*_j(arrs), chunk=chunk, interpret=True)
    before = ssd_scan.launches
    got = ssd_scan(*_t(arrs), chunk=chunk)
    assert ssd_scan.launches == before      # CPU tensors: the twin, no launch
    assert got.dtype == torch.float32 and got.shape == (b, s, h, dh)
    _close(got, want)
    assert torch.equal(got, ssd_scan_plain(*_t(arrs), chunk=chunk))
    # and the recurrence, as the JAX test holds the Pallas kernel.
    x, dt, A, B, C = _j(arrs)
    rec = jax.vmap(lambda xx, dd, bb, cc: jref.ssd_recurrence_ref(
        xx, dd, A, bb, cc)[0])(x, dt, B, C)
    _close(got, rec)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ops_ssd_matches_jax_ops(use_pallas):
    arrs = _inputs(9, 2, 96, 3, 16, 16)
    want = jops.ssd(*_j(arrs), chunk=32, use_pallas=use_pallas)
    _close(ops.ssd(*_t(arrs), chunk=32, use_pallas=use_pallas), want)


def test_ops_ssd_reference_branch_pads_ragged_lengths():
    arrs = _inputs(10, 2, 45, 2, 16, 16)
    want = jops.ssd(*_j(arrs), chunk=16, use_pallas=False)
    _close(ops.ssd(*_t(arrs), chunk=16, use_pallas=False), want)


def test_ragged_length_raises_like_the_reference():
    arrs = _inputs(11, 1, 40, 2, 16, 16)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        jscan(*_j(arrs), chunk=16, interpret=True)
    for fn in (ssd_scan, ssd_scan_plain):
        with pytest.raises(ValueError, match="not a multiple of chunk"):
            fn(*_t(arrs), chunk=16)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ops.ssd(*_t(arrs), chunk=16, use_pallas=True)


def test_wrapper_refuses_non_cpu_tensors_without_a_kernel():
    """No silent fallback: tensors off the CPU launch the kernel or
    raise; meta tensors raise before any launch."""
    x, dt, A, B, C = _t(_inputs(12, 1, 32, 2, 16, 16))
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_scan(x.to("meta"), dt, A, B, C, chunk=16)
