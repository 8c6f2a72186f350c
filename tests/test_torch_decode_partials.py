"""B3's sequence-split mode on the CPU: a dense cache cut into 1-4 shards
along the sequence, each shard read with its global key offset as
unnormalised (acc, m, l) partials and the partials combined in shard
order (``combine_decode_partials``), equals the whole-cache read, for
B3's plain twin (``flash_attention_decode_plain``, what the CUDA kernel
is held against on the card) and for the model's non-flash
``layers.attention_decode``.  The cases include shards that lie wholly
past a row's position (no valid key: m = NEG_INF, l = 0, no weight), a
band window, and a row with no valid key anywhere, which C3 keeps out of
oracle comparisons (the kernels' rule gives it 0, here on both sides).
The wrapper routes CPU tensors to the twin with the same arguments, and
the roofline counter's live keys over the shards sum to the whole
cache's."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L
from repro_torch.roofline import count as C

torch.set_num_threads(2)

# (hq, hkv, S, window, per-row positions); -1: no valid key in the row
CASES = {
    "gqa-8-2": (8, 2, 96, None, [95, 17, 0, 50]),
    "mqa-8-1": (8, 1, 96, None, [40, 95, 63, 1]),
    "band-24": (8, 2, 96, 24, [95, 10, 30, 70]),
    "empty-row": (4, 2, 48, None, [-1, 47, 5, 23]),
}


def _inputs(name, dtype, seed=0):
    hq, hkv, S, window, pos = CASES[name]
    g = torch.Generator().manual_seed(seed)
    b, d = len(pos), 32
    q = torch.randn(b, hq, 1, d, generator=g).to(dtype)
    k = torch.randn(b, hkv, S, d, generator=g).to(dtype)
    v = torch.randn(b, hkv, S, d, generator=g).to(dtype)
    return q, k, v, torch.tensor(pos, dtype=torch.int32), window


def _shards(n, q, k, v, pos, window, read):
    """Every shard's partials, stacked in shard order, and combined."""
    S = k.shape[2]
    w = S // n
    parts = [read(q, k[:, :, i * w:(i + 1) * w], v[:, :, i * w:(i + 1) * w],
                  pos, window, i * w) for i in range(n)]
    acc = torch.stack([a for a, _ in parts])
    ml = torch.stack([m for _, m in parts])
    return acc, ml, fa.combine_decode_partials(acc, ml)


def _twin(q, k, v, pos, window, off):
    return fa.flash_attention_decode_plain(q, k, v, pos, window=window,
                                           key_offset=off, partials=True)


def _plain_read(q, k, v, pos, window, off):
    kpos = torch.arange(k.shape[2])[None, :] + off
    p = pos.to(torch.int64)[:, None]
    valid = kpos <= p
    if window is not None:
        valid &= kpos > p - window
    return L.attention_decode(q, k, v, valid, partials=True)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_twin_shards_combine_to_the_whole_cache(case, n):
    q, k, v, pos, window = _inputs(case, torch.float32)
    acc, ml, got = _shards(n, q, k, v, pos, window, _twin)
    want = fa.flash_attention_decode_plain(q, k, v, pos, window=window)
    torch.testing.assert_close(got[:, :, None], want, rtol=1e-5, atol=1e-5)
    live = (pos >= 0).tolist()
    for r, ok in enumerate(live):
        if not ok:       # no valid key anywhere: every part empty, out 0
            assert (ml[:, r, :, 0] == fa.NEG_INF).all()
            assert (ml[:, r, :, 1] == 0).all() and (acc[:, r] == 0).all()
            assert (got[r] == 0).all() and (want[r] == 0).all()
    # a shard wholly past a row's position carries no weight.
    w = k.shape[2] // n
    for i in range(n):
        past = pos.to(torch.int64) < i * w
        assert (ml[i, past, :, 1] == 0).all()
        assert (ml[i, past, :, 0] == fa.NEG_INF).all()


@pytest.mark.parametrize("n", [2, 3])
def test_twin_bf16_shards_within_a_bf16_ulp(n):
    q, k, v, pos, window = _inputs("gqa-8-2", torch.bfloat16, seed=1)
    _, _, got = _shards(n, q, k, v, pos, window, _twin)
    want = fa.flash_attention_decode_plain(q, k, v, pos, window=window)
    ulp = want.float().abs().clamp(min=1e-3) * 2.0 ** -7
    assert ((got.to(torch.bfloat16).float()[:, :, None] - want.float()).abs()
            <= ulp).all()


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["gqa-8-2", "mqa-8-1", "band-24"])
def test_attention_decode_shards_combine_to_the_whole_cache(case, n):
    q, k, v, pos, window = _inputs(case, torch.float32, seed=2)
    _, _, got = _shards(n, q, k, v, pos, window, _plain_read)
    kpos = torch.arange(k.shape[2])[None, :]
    p = pos.to(torch.int64)[:, None]
    valid = kpos <= p
    if window is not None:
        valid &= kpos > p - window
    want = L.attention_decode(q, k, v, valid)
    torch.testing.assert_close(got[:, :, None], want, rtol=1e-5, atol=1e-5)
    # the model's read and B3's twin give the same partials.
    for got_p, want_p in zip(_shards(n, q, k, v, pos, window, _plain_read),
                             _shards(n, q, k, v, pos, window, _twin)):
        torch.testing.assert_close(got_p, want_p, rtol=1e-5, atol=1e-5)


def test_wrapper_routes_cpu_tensors_to_the_twin():
    q, k, v, pos, window = _inputs("gqa-8-2", torch.float32, seed=3)
    before = fa.flash_attention_decode.launches
    got = fa.flash_attention_decode(q, k[:, :, 48:], v[:, :, 48:], pos,
                                    key_offset=48, partials=True)
    want = _twin(q, k[:, :, 48:], v[:, :, 48:], pos, None, 48)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fa.flash_attention_decode.launches == before


def test_ring_cache_is_never_split():
    q, k, v, pos, _ = _inputs("gqa-8-2", torch.float32)
    with pytest.raises(ValueError, match="ring"):
        fa.flash_attention_decode_plain(q, k, v, pos, window=96, ring=True,
                                        key_offset=32)


@pytest.mark.parametrize("case", list(CASES))
def test_counted_live_keys_sum_over_shards(case):
    q, k, v, pos, window = _inputs(case, torch.float32)
    b, hkv, S, d = k.shape
    row = hkv * d * 2 * k.element_size()
    whole = fa._dense_work(q, k, v, pos, window)[1] - 2 * C._nbytes(q)
    for n in (2, 3, 4):
        w = S // n
        parts = sum(fa._dense_work(q, k[:, :, i * w:(i + 1) * w],
                                   v[:, :, i * w:(i + 1) * w], pos, window,
                                   key_offset=i * w)[1] - 2 * C._nbytes(q)
                    for i in range(n))
        assert parts == whole, (n, parts / row, whole / row)
