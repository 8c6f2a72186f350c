"""Card-only checks of the port's kernels (marker ``cuda``).

They skip without a CUDA card: a CUDA kernel has no CPU mode, and the
CPU tests hold each kernel's plain twin against the JAX package instead.
On a machine with a card and nvcc (which need not have JAX):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

B6 (``ssd_scan``): the kernel against its plain twin on the card, at
small shapes that cover a chunk of one, two and four 64-row tiles, a
chunk that is not a multiple of 64, ds of 16 to 128, dh slabs of 16, 32
and 64, and the ragged-length error.  Tolerance 2e-4 absolute and
relative, the JAX tests' own for the Pallas kernel (fp32, sums in
another order).

B5 (``flash_attention``) and B1 (``flash_attention_decode_paged``): the
kernels against their plain twins at every bf16 head dim, single-row and
ragged q tiles, windows, no causal mask, and B1's split-KV edges (many
splits on one sequence, splits with no live key, int8 and verify rows
with splits, a one-tile ring, pages of 12 keys).  Tolerance: bf16 outputs
within 2 bf16 ulps of |plain| + 1e-5 and fp32 within 1e-4, the rule of
``chip_smoke.py`` (both accumulate in fp32 and round once).
"""

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
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
                hkv=8, d=128, quant=False, window=None, ring=False):
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
    pos = torch.randint(max_pos // 8, max_pos - sq + 1, (b,), generator=gen,
                        device=dev).int()
    base = None
    if ring:
        cur = pos.long()[:, None] // page
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
], ids=["main", "many-splits", "empty-splits", "int8-splits",
        "verify-splits", "ring-one-split", "window-splits", "page-12-int8"])
def test_paged_decode_kernel_matches_twin(card, kw):
    gen = torch.Generator(device=card).manual_seed(kw["n_blocks"])
    c = _paged_case(gen, card, **kw)
    before = fa.flash_attention_decode_paged.launches
    got = fa.flash_attention_decode_paged(**c)
    torch.cuda.synchronize()
    assert fa.flash_attention_decode_paged.launches == before + 1
    _assert_attention_close(got, fa.flash_attention_decode_paged_plain(**c))
