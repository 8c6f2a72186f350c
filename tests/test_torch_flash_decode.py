"""Port parity: paged decode attention.

The port's plain ``flash_attention_decode_paged_plain`` (what the CUDA
kernel is held against on the card) must match the JAX Pallas kernel
``repro.kernels.flash_attention.flash_attention_decode_paged`` — run in
interpret mode on the CPU, as ``tests/test_paged_kv.py`` runs it — for
every option: sq in {1, 3}, window None/24, ring ``page_base``, int8
pools with bf16 scales, and table entries >= n_pages.  Inputs are fp32
(the pools bf16 or int8), so the tolerance is fp32 summation order:
1e-5 absolute.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import (
    flash_attention_decode_paged as jax_paged)
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (
    flash_attention_decode_paged, flash_attention_decode_paged_plain)

torch.set_num_threads(2)

TOL = 1e-5

B, HQ, HKV, D = 3, 8, 2, 32
N_PAGES, PAGE = 12, 8


def _inputs(variant, sq, seed):
    rng = np.random.default_rng(seed)
    nb = 4 if variant == "ring" else 6
    shape = (N_PAGES, HKV, PAGE, D)
    if variant == "int8":
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, shape[:3] + (1,)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, shape[:3] + (1,)).astype(np.float32)
    else:
        # bf16-representable pools: both packages read identical values.
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    q = rng.standard_normal((B, HQ, sq, D)).astype(np.float32)
    bt = np.stack([rng.permutation(N_PAGES)[:nb] for _ in range(B)]
                  ).astype(np.int32)
    pos = np.asarray([5, 21, nb * PAGE - sq], np.int32)
    base = None
    if variant == "unalloc":
        live = (pos + sq - 1) // PAGE
        bt = np.where(np.arange(nb)[None, :] > live[:, None], N_PAGES + 3,
                      bt).astype(np.int32)
    if variant == "ring":
        pos = np.asarray([9, 43, 61], np.int32)
        cur = pos[:, None] // PAGE
        j = np.arange(nb)[None, :]
        base = ((cur - ((cur - j) % nb)) * PAGE).astype(np.int32)
    return dict(q=q, k_pages=kp, v_pages=vp, block_tab=bt, pos=pos,
                page_base=base, k_scale_pages=ks, v_scale_pages=vs)


def _jax(x):
    out = {}
    for k, v in x.items():
        if v is None:
            out[k] = None
        elif k.endswith("scale_pages"):
            out[k] = jnp.asarray(v).astype(jnp.bfloat16)
        elif k in ("k_pages", "v_pages") and v.dtype == np.float32:
            out[k] = jnp.asarray(v).astype(jnp.bfloat16)
        else:
            out[k] = jnp.asarray(v)
    return out


def _torch(x):
    out = {}
    for k, v in x.items():
        if v is None:
            out[k] = None
        elif k.endswith("scale_pages") or (k in ("k_pages", "v_pages")
                                           and v.dtype == np.float32):
            out[k] = torch.from_numpy(v).to(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v)
    return out


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("variant", ["flat", "ring", "int8", "unalloc"])
def test_plain_matches_jax_pallas_kernel(variant, sq, window):
    x = _inputs(variant, sq, seed=sq * 10 + (window or 0))
    gold = np.asarray(jax_paged(**_jax(x), window=window, interpret=True))
    got = flash_attention_decode_paged_plain(**_torch(x), window=window)
    assert got.dtype == torch.float32 and got.shape == (B, HQ, sq, D)
    assert np.abs(got.numpy() - gold).max() <= TOL
    # the CPU wrapper is the plain version, and launches nothing.
    before = flash_attention_decode_paged.launches
    wrapped = flash_attention_decode_paged(**_torch(x), window=window)
    assert torch.equal(wrapped, got)
    assert flash_attention_decode_paged.launches == before


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("variant", ["flat", "ring", "int8", "unalloc"])
def test_port_ref_matches_jax_ref_and_plain(variant, window):
    """The port's oracle equals the JAX oracle, and the plain kernel twin
    equals both on every row that has a valid key (the oracles give NaN
    where the kernels give 0)."""
    x = _inputs(variant, 3, seed=7)
    jgold = np.asarray(jref.paged_attention_ref(**_jax(x), window=window))
    tgold = tref.paged_attention_ref(**_torch(x), window=window).numpy()
    np.testing.assert_array_equal(np.isnan(tgold), np.isnan(jgold))
    ok = ~np.isnan(jgold)
    assert np.abs(tgold[ok] - jgold[ok]).max() <= TOL
    plain = flash_attention_decode_paged_plain(**_torch(x),
                                               window=window).numpy()
    assert np.abs(plain[ok] - jgold[ok]).max() <= TOL
    assert np.all(plain[~ok] == 0)


def test_empty_rows_are_zero_not_nan():
    """A row whose every key is masked outputs 0 (the l == 0 guard)."""
    x = _torch(_inputs("ring", 1, seed=3))
    x["page_base"] = torch.full_like(x["page_base"], -PAGE)   # never written
    out = flash_attention_decode_paged_plain(**x)
    assert torch.count_nonzero(out) == 0


def test_bf16_q_output_dtype_and_rounding():
    x = _torch(_inputs("flat", 1, seed=5))
    x["q"] = x["q"].to(torch.bfloat16)
    out = flash_attention_decode_paged_plain(**x)
    assert out.dtype == torch.bfloat16
    f32 = flash_attention_decode_paged_plain(**dict(x, q=x["q"].float()))
    assert torch.equal(out, f32.to(torch.bfloat16))


def test_attention_ref_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4, 5, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    for window in (None, 4):
        gold = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), window=window))
        got = tref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), window=window)
        assert np.abs(got.numpy() - gold).max() <= TOL


def test_wrapper_refuses_non_cpu_tensors_without_a_kernel():
    """No silent fallback: tensors that are not on the CPU go to the
    kernel or raise — here (meta tensors) they raise before any launch."""
    x = {k: (v.to("meta") if v is not None else None)
         for k, v in _torch(_inputs("flat", 1, seed=2)).items()}
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_decode_paged(**x)
    mixed = _torch(_inputs("flat", 1, seed=2))
    mixed["q"] = mixed["q"].to("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_decode_paged(**mixed)


def test_build_keys_libraries_by_source_hash_and_needs_nvcc(tmp_path,
                                                          monkeypatch):
    """An edited source gets a new library path (so it rebuilds), and a
    machine without nvcc gets a clear error instead of a CPU fallback."""
    from repro_torch.kernels import build
    src = tmp_path / "k.cu"
    src.write_text("extern \"C\" int k() { return 0; }\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    assert list(build.sources()) == ["k"]
    first = build._lib_path(src)
    src.write_text("extern \"C\" int k() { return 1; }\n")
    assert build._lib_path(src) != first
    assert first.parent == tmp_path / "out" and first.name.startswith("k-")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "CUDA_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library("k")
