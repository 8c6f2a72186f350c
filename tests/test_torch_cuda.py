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
"""

import pytest
import torch

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
