"""Card-only checks of the port's kernels (marker ``cuda``).

They skip without a CUDA card: a CUDA kernel has no CPU mode, and the
CPU tests hold each kernel's plain twin against the JAX package instead.
On a machine with a card and nvcc (which need not have JAX):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

B6 (``ssd_scan``): the kernel against its plain twin on the card, at
small shapes that cover a chunk of one, two and four 64-row tiles, a
chunk that is not a multiple of 64, ds of 16 to 128, dh slabs of 16, 32
and 64, and the ragged-length error; and at its edges: one chunk and 64
chunks (the serial state pass), chunks of 48 and 1024, zero dt, a decay
|A| dt so large that exp underflows to 0, with every output finite.
Tolerance 2e-4 absolute and relative, the JAX tests' own for the Pallas
kernel (fp32, sums in another order).

B4 (``rmsnorm``): rows 1, 8 and 4096 at d 3072, d not a multiple of the
16-byte vector, d 16384 (bf16 in registers, fp32 through the two-pass
kernel), fp32 and bf16 x with fp32 and bf16 w; bf16 within 2 bf16 ulps
of |plain| + 1e-5 and fp32 within 1e-5 (``chip_smoke.py``'s rules).

B5 (``flash_attention``) and B1 (``flash_attention_decode_paged``): the
kernels against their plain twins at every bf16 head dim, single-row and
ragged q tiles, windows, no causal mask, and B1's split-KV edges (many
splits on one sequence, splits with no live key, int8 and verify rows
with splits, a one-tile ring, pages of 12 keys), and B1 at gemma3-12b's
local layers (d 256, 16 / 8 heads, a 65- and 66-page ring of 16-key
pages under a 1024 window, positions 1100-1560 and before the wrap, sq
1 and 5, bf16 and int8 pages, bases from the span's last row as the
model computes them).  Tolerance: bf16 outputs
within 2 bf16 ulps of |plain| + 1e-5 and fp32 within 1e-4, the rule of
``chip_smoke.py`` (both accumulate in fp32 and round once).

B3 (``flash_attention_decode``) under the same rule at its split-KV
edges: one slot of 4096 keys (a split per tile), positions 0 and 1
(most splits empty), positions at and past S, band and ring with
splits, zamba2's widths, fp32, fp32 at d = 256 (half tiles), and
gemma3-12b's bf16 shapes at d 256: the local layers' ring of S == window
== 1024 (positions before, at and past the wrap) and the global layers'
flat 2048.

B7 (``tree_row_reduce``) bit for bit, both regimes (a warp per row; few
long rows split over CTAs) and every vector edge: N = 2^k + 1, rows that
break 16-byte alignment, an unaligned start, -0.0 rows for add, +-inf,
NaN and +-0.0 rows for max; compared by their bits, since -0.0 == 0.0
and NaN != NaN.

B2 (``kv_quantize`` and ``kv_quantize_store``) bit for bit: every plan
of lanes per row (d 8 to 512, fp32 and bf16), the slot cache of 65 536
rows, and the store into dense slot caches (slots in range, on a ring,
clamped to S - 1) and page pools with dropped rows, with rows of exact
.5 quotients (round half to even).
"""

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_quant as kq
from repro_torch.kernels import rmsnorm_kernel as rk
from repro_torch.kernels import treereduce_kernel as tk
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(gen, b, s, h, dh, ds, dev):
    def rnd(*shape, lo=None, hi=None):
        if lo is None:
            return torch.randn(shape, generator=gen, device=dev) * 0.5
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
    return (rnd(b, s, h, dh), rnd(b, s, h, lo=0.1, hi=0.5),
            -rnd(h, lo=0.5, hi=1.5), rnd(b, s, ds), rnd(b, s, ds))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dh,ds,chunk", [
    (2, 192, 3, 64, 32, 64),
    (1, 512, 2, 64, 128, 256),
    (2, 96, 3, 32, 16, 48),
    (1, 64, 1, 16, 64, 64),
    (3, 256, 2, 48, 48, 128),
])
def test_ssd_scan_kernel_matches_twin(card, b, s, h, dh, ds, chunk):
    gen = torch.Generator(device=card).manual_seed(s + h)
    args = _inputs(gen, b, s, h, dh, ds, card)
    before = ssd_scan.launches
    got = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want = ssd_scan_plain(*args, chunk=chunk)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dh,ds,chunk,kind", [
    (2, 256, 3, 64, 128, 256, None),        # one chunk
    (1, 4096, 2, 32, 64, 64, None),         # 64 chunks
    (1, 2048, 2, 64, 128, 1024, None),      # chunk 1024
    (2, 480, 3, 16, 48, 48, None),          # chunk 48, ds 48, dh 16
    (2, 512, 2, 48, 16, 128, "zero_dt"),    # dt 0 on every third row
    (2, 768, 2, 64, 128, 256, "deep"),      # exp(cum) underflows to 0
    (1, 1024, 4, 32, 128, 256, "deep"),
], ids=["nc-1", "nc-64", "chunk-1024", "chunk-48", "zero-dt", "deep-decay",
        "deep-decay-dh32"])
def test_ssd_scan_kernel_edges(card, b, s, h, dh, ds, chunk, kind):
    gen = torch.Generator(device=card).manual_seed(s + dh)
    x, dt, A, B, C = _inputs(gen, b, s, h, dh, ds, card)
    if kind == "zero_dt":
        dt[:, ::3] = 0.0
    elif kind == "deep":
        A = A * 200.0
    before = ssd_scan.launches
    got = ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert torch.isfinite(got).all()
    want = ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,x_dtype,w_dtype", [
    (1, 3072, torch.bfloat16, torch.bfloat16),
    (8, 3072, torch.bfloat16, torch.bfloat16),
    (4096, 3072, torch.bfloat16, torch.bfloat16),
    (4096, 3072, torch.float32, torch.float32),
    (8, 3072, torch.bfloat16, torch.float32),
    (8, 3072, torch.float32, torch.bfloat16),
    (5, 3071, torch.bfloat16, torch.bfloat16),
    (300, 1001, torch.float32, torch.float32),
    (5, 100, torch.float32, torch.float32),
    (16, 16384, torch.bfloat16, torch.bfloat16),
    (16, 16384, torch.float32, torch.float32),
])
def test_rmsnorm_kernel_matches_twin(card, rows, d, x_dtype, w_dtype):
    gen = torch.Generator(device=card).manual_seed(rows + d)
    x = torch.randn((rows, d), generator=gen, device=card).to(x_dtype)
    w = (torch.randn((d,), generator=gen, device=card) * 0.1).to(w_dtype)
    before = rk.rmsnorm.launches
    got = rk.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rk.rmsnorm.launches == before + 1
    want = rk.rmsnorm_plain(x, w)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    if x_dtype == torch.float32:
        assert diff.max().item() <= 1e-5
    else:
        ax = want.float().abs().clamp(min=1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(ax)) - 7)
        assert (diff <= 2 * ulp + 1e-5).all(), diff.max().item()


@pytest.mark.cuda
def test_ssd_scan_kernel_raises_on_ragged_length(card):
    gen = torch.Generator(device=card).manual_seed(0)
    args = _inputs(gen, 1, 100, 2, 32, 16, card)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ssd_scan(*args, chunk=64)


def _assert_attention_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        assert diff.max().item() <= 1e-4
        return
    ax = want.float().abs().clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(ax)) - 7)
    assert (diff <= 2 * ulp + 1e-5).all(), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,dtype", [
    (2, 8, 2, 300, 300, 32, True, None, torch.bfloat16),
    (1, 8, 2, 200, 700, 64, True, 100, torch.bfloat16),
    (2, 6, 2, 257, 257, 128, True, None, torch.bfloat16),
    (2, 4, 4, 250, 1000, 192, True, None, torch.bfloat16),
    (1, 4, 2, 300, 300, 256, True, 64, torch.bfloat16),
    (2, 4, 2, 1, 64, 128, True, None, torch.bfloat16),
    (2, 4, 2, 17, 64, 128, True, None, torch.bfloat16),
    (1, 4, 2, 17, 64, 256, True, None, torch.bfloat16),
    (1, 4, 2, 333, 1030, 128, False, None, torch.bfloat16),
    (2, 4, 2, 300, 200, 128, True, None, torch.bfloat16),
    (1, 4, 2, 200, 300, 64, False, None, torch.float32),
])
def test_flash_attention_kernel_matches_twin(card, b, hq, hkv, sq, sk, d,
                                             causal, window, dtype):
    gen = torch.Generator(device=card).manual_seed(sq * 7 + d)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for shape in ((b, hq, sq, d), (b, hkv, sk, d),
                             (b, hkv, sk, d)))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _assert_attention_close(got, fa.flash_attention_plain(
        q, k, v, causal=causal, window=window))


def _paged_case(gen, dev, *, b, n_blocks, max_pos, sq=1, page=16, hq=24,
                hkv=8, d=128, quant=False, window=None, ring=False,
                min_pos=None):
    n_pages = b * n_blocks
    shape = (n_pages, hkv, page, d)
    if quant:
        kp, vp = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = ((torch.rand(shape[:3] + (1,), generator=gen, device=dev)
                   * 0.015 + 0.005).bfloat16() for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                  for _ in range(2))
        ks = vs = None
    q = torch.randn((b, hq, sq, d), generator=gen, device=dev).bfloat16()
    bt = torch.randperm(n_pages, generator=gen, device=dev).reshape(
        b, n_blocks).int().contiguous()
    lo = max_pos // 8 if min_pos is None else min_pos
    pos = torch.randint(lo, max_pos - sq + 1, (b,), generator=gen,
                        device=dev).int()
    base = None
    if ring:        # the served rule: bases from the span's last row
        cur = (pos.long()[:, None] + sq - 1) // page
        j = torch.arange(n_blocks, device=dev)[None, :]
        base = ((cur - ((cur - j) % n_blocks)) * page).int().contiguous()
    return dict(q=q, k_pages=kp, v_pages=vp, block_tab=bt, pos=pos,
                window=window, page_base=base, k_scale_pages=ks,
                v_scale_pages=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(b=8, n_blocks=64, max_pos=1024),
    dict(b=1, n_blocks=256, max_pos=4096),
    dict(b=8, n_blocks=64, max_pos=40),
    dict(b=1, n_blocks=256, max_pos=4096, quant=True),
    dict(b=1, n_blocks=256, max_pos=4096, sq=4),
    dict(b=8, n_blocks=4, max_pos=1024, window=48, ring=True),
    dict(b=2, n_blocks=64, max_pos=1024, window=300),
    dict(b=4, n_blocks=86, max_pos=1024, page=12, quant=True),
    dict(b=8, n_blocks=64, max_pos=1024, sq=5),
    dict(b=8, n_blocks=64, max_pos=1024, sq=5, quant=True),
    dict(b=2, n_blocks=64, max_pos=1024, sq=8, window=300),
    dict(b=4, n_blocks=86, max_pos=1024, page=12, sq=5, quant=True),
    # gemma3-12b's local layers: d 256, 16 / 8 heads, a 65-page ring
    # (66 with speculate_k 4) under a 1024 window, positions past it.
    dict(b=8, n_blocks=65, hq=16, hkv=8, d=256, window=1024, ring=True,
         min_pos=1100, max_pos=1561),
    dict(b=8, n_blocks=65, hq=16, hkv=8, d=256, window=1024, ring=True,
         min_pos=1100, max_pos=1561, quant=True),
    dict(b=8, n_blocks=66, hq=16, hkv=8, d=256, window=1024, ring=True,
         min_pos=1100, max_pos=1561, sq=5),
    dict(b=8, n_blocks=66, hq=16, hkv=8, d=256, window=1024, ring=True,
         min_pos=1100, max_pos=1561, sq=5, quant=True),
    dict(b=8, n_blocks=66, hq=16, hkv=8, d=256, window=1024, ring=True,
         min_pos=0, max_pos=1100, sq=5),
], ids=["main", "many-splits", "empty-splits", "int8-splits",
        "verify-splits", "ring-one-split", "window-splits", "page-12-int8",
        "verify-5", "verify-5-int8", "verify-8-rows-24-window",
        "verify-5-page-12-int8", "gemma3-ring-d256", "gemma3-ring-d256-int8",
        "gemma3-ring-d256-verify-5", "gemma3-ring-d256-verify-5-int8",
        "gemma3-ring-d256-verify-5-before-wrap"])
def test_paged_decode_kernel_matches_twin(card, kw):
    gen = torch.Generator(device=card).manual_seed(kw["n_blocks"])
    c = _paged_case(gen, card, **kw)
    before = fa.flash_attention_decode_paged.launches
    got = fa.flash_attention_decode_paged(**c)
    torch.cuda.synchronize()
    assert fa.flash_attention_decode_paged.launches == before + 1
    _assert_attention_close(got, fa.flash_attention_decode_paged_plain(**c))


def _dense_case(gen, dev, *, b=8, hq=24, hkv=8, d=128, S=1024, pos=None,
                max_pos=1024, dtype=torch.bfloat16, window=None, ring=False):
    q = torch.randn((b, hq, 1, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, hkv, S, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    if pos is None:
        pos = torch.randint(max_pos // 8, max_pos, (b,), generator=gen,
                            device=dev)
    pos = torch.as_tensor(pos, device=dev).int().contiguous()
    return dict(q=q, k=k, v=v, pos=pos, window=window, ring=ring)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(),
    dict(b=1, S=4096, pos=[4095]),
    dict(b=4, S=4096, pos=[0, 1, 0, 1]),
    dict(pos=[1023, 1024, 1500, 99999, 0, 1, 64, 65]),
    dict(b=2, S=4096, pos=[3000, 4095], window=700),
    dict(b=8, S=256, window=256, ring=True,
         pos=[10, 100, 255, 256, 300, 1000, 4000, 200]),
    dict(b=2, S=2048, window=2048, ring=True, pos=[5000, 100]),
    dict(hq=32, hkv=32, d=64, pos=[0, 1, 63, 64, 65, 511, 1022, 1023]),
    dict(b=2, S=1000, dtype=torch.float32),
    dict(b=2, hq=8, hkv=1, S=300, d=256, dtype=torch.float32),
    # gemma3-12b: d 256, 16 / 8 heads, bf16; local layers a rolled ring of
    # S == window == 1024 (before and after the wrap), global 2048 flat.
    dict(hq=16, hkv=8, d=256, S=1024, window=1024, ring=True,
         pos=[1100, 1560, 1023, 1024, 700, 1300, 2047, 5]),
    dict(hq=16, hkv=8, d=256, S=2048, max_pos=1561),
], ids=["main", "one-slot-4096", "pos-0-1", "pos-past-S", "band-splits",
        "ring-splits", "ring-wrapped", "zamba2", "f32", "f32-d256",
        "gemma3-ring-d256", "gemma3-global-d256"])
def test_dense_decode_kernel_matches_twin(card, kw):
    gen = torch.Generator(device=card).manual_seed(len(kw))
    c = _dense_case(gen, card, **kw)
    before = fa.flash_attention_decode.launches
    got = fa.flash_attention_decode(**c)
    torch.cuda.synchronize()
    assert fa.flash_attention_decode.launches == before + 1
    _assert_attention_close(got, fa.flash_attention_decode_plain(**c))


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _tree_rows(gen, dev, rows, n, dtype, fill, offset):
    x = torch.randn(rows * n + offset, generator=gen, device=dev)
    x = x[offset:].view(rows, n)
    if fill == "neg-zero":
        x[0] = -0.0
    elif fill == "inf":
        x[0, ::7] = float("inf")
        x[1] = float("-inf")
        x[2, n // 2] = float("nan")
    elif fill == "signed-zero":
        x[0, ::2] = 0.0
        x[0, 1::2] = -0.0
        x[1] = -0.0
    return x.to(dtype) if dtype != torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,dtype,op,fill,offset", [
    (300, 4096, torch.float32, "add", None, 0),
    (300, 4096, torch.bfloat16, "max", None, 0),
    (16, 256000, torch.float32, "add", None, 0),
    (16, 256000, torch.bfloat16, "add", None, 0),
    (16, 256000, torch.float32, "max", "inf", 0),
    (1, 1 << 24, torch.float32, "add", None, 0),
    (3, (1 << 20) + 1, torch.float32, "add", None, 0),
    (5, 4097, torch.bfloat16, "add", None, 0),
    (7, 1001, torch.bfloat16, "add", None, 0),
    (9, 1003, torch.float32, "max", None, 0),
    (6, 4096, torch.float32, "add", None, 1),
    (4, 65536, torch.float32, "add", "neg-zero", 0),
    (4, 1000, torch.float32, "add", "neg-zero", 0),
    (4, 4096, torch.float32, "max", "inf", 0),
    (4, 4096, torch.bfloat16, "max", "inf", 0),
    (4, 1000, torch.float32, "max", "signed-zero", 0),
    (4, 65536, torch.float32, "max", "signed-zero", 0),
    (5, 1, torch.float32, "max", None, 0),
    (3, 5, torch.float32, "add", None, 0),
    (2, 8, torch.bfloat16, "add", None, 0),
])
def test_tree_row_reduce_kernel_bit_equal(card, rows, n, dtype, op, fill,
                                          offset):
    gen = torch.Generator(device=card).manual_seed(rows + n)
    x = _tree_rows(gen, card, rows, n, dtype, fill, offset)
    before = tk.tree_row_reduce.launches
    got = tk.tree_row_reduce(x, op)
    torch.cuda.synchronize()
    assert tk.tree_row_reduce.launches == before + 1
    want = tk.tree_row_reduce_plain(x, op)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want)), (got, want)


def _quant_rows(gen, dev, shape, dtype, ties=False):
    """Rows of widely varying scale; an all-zero row; with ``ties`` every
    row holds exact .5 quotients (amax 127 gives scale 1 exactly)."""
    x = (torch.randn(shape, generator=gen, device=dev)
         * torch.rand(shape[:-1] + (1,), generator=gen, device=dev) * 8)
    flat = x.view(-1, shape[-1])
    flat[1] = 0.0
    if ties:
        flat[:] = torch.tensor([2.5, -3.5, 0.5, 1.5, -0.5, 127.0, 4.5,
                                -126.5] * (shape[-1] // 8), device=dev)
    return x.to(dtype)


def _quant_leaves(gen, dev, shape):
    q = {n: torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8) for n in "kv"}
    s = {n + "_scale": torch.rand(shape[:-1] + (1,), generator=gen,
                                  device=dev).bfloat16() for n in "kv"}
    return {**q, **s}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype", [
    (64, 128, torch.bfloat16), (64, 128, torch.float32),
    (65536, 128, torch.bfloat16), (1000, 64, torch.bfloat16),
    (999, 256, torch.float32), (77, 512, torch.bfloat16),
    (77, 512, torch.float32), (5, 8, torch.bfloat16),
])
def test_kv_quantize_kernel_bit_equal(card, rows, d, dtype):
    gen = torch.Generator(device=card).manual_seed(rows + d)
    x = _quant_rows(gen, card, (rows, d), dtype)
    before = kq.kv_quantize.launches
    q, s = kq.kv_quantize(x)
    torch.cuda.synchronize()
    assert kq.kv_quantize.launches == before + 1
    pq, ps = kq.kv_quantize_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,d,dtype,ties", [
    ("dense", 128, torch.bfloat16, False),
    ("dense", 128, torch.float32, False),
    ("ring", 64, torch.bfloat16, False),
    ("clamped", 256, torch.bfloat16, False),
    ("clamped", 256, torch.float32, False),
    ("paged", 128, torch.bfloat16, False),
    ("paged", 64, torch.float32, False),
    ("paged", 256, torch.bfloat16, False),
    ("dense", 128, torch.float32, True),
    ("paged", 128, torch.bfloat16, True),
])
def test_kv_quantize_store_kernel_bit_equal(card, layout, d, dtype, ties):
    """Dense slot caches (slots in range, on a ring, clamped to S - 1) and
    page pools with dropped rows (an unallocated page, positions past the
    table, a padded chunk tail, a read-only prefix): every leaf equal to
    the twin's after the store."""
    from repro_torch.models import layers
    gen = torch.Generator(device=card).manual_seed(d + len(layout))
    hkv = 8
    if layout == "paged":
        n_pages, page, b, s = 40, 16, 4, 24
        leaves = _quant_leaves(gen, card, (n_pages, hkv, page, d))
        bt = torch.randperm(n_pages, generator=gen, device=card)[:12].reshape(
            b, 3).int()
        bt[1, 2] = n_pages                               # unallocated
        pos = torch.tensor([0, 20, 30, 5], device=card)  # row 2 past the table
        rows = layers.paged_store_rows(
            bt, pos, s, page, n_pages, hkv,
            torch.tensor([23, 23, 23, 9], device=card),  # row 3: padded tail
            torch.tensor([0, 26, 0, 0], device=card))    # row 1: read-only
        shape = (b, s, hkv, d)
    else:
        b, S = 8, 1024
        leaves = _quant_leaves(gen, card, (b, hkv, S, d))
        pos = torch.randint(0, 4 * S, (b,), generator=gen, device=card)
        slot = {"dense": pos % S, "ring": pos % S,
                "clamped": pos.clamp(max=S - 1)}[layout]
        if layout == "clamped":
            slot[0] = S - 1
        rows = kq.kv_store_rows(torch.arange(b, device=card), slot, hkv, S)
        shape = (b, hkv, d)
    k = _quant_rows(gen, card, shape, dtype, ties)
    v = _quant_rows(gen, card, shape, dtype, ties)
    twin = {n: t.clone() for n, t in leaves.items()}
    before = kq.kv_quantize_store.launches
    kq.kv_quantize_store(k, v, leaves["k"], leaves["v"], leaves["k_scale"],
                         leaves["v_scale"], rows)
    torch.cuda.synchronize()
    assert kq.kv_quantize_store.launches == before + 1
    kq.kv_quantize_store_plain(k, v, twin["k"], twin["v"], twin["k_scale"],
                               twin["v_scale"], rows)
    for name in leaves:
        assert torch.equal(leaves[name], twin[name]), name
    if layout == "paged":
        assert (rows < 0).any() and (rows >= 0).any()
    if ties:
        kept = rows.reshape(-1)[rows.reshape(-1) >= 0][0]
        assert leaves["k"].view(-1, d)[kept, :8].tolist() == [
            2, -4, 0, 2, 0, 127, 4, -126]
