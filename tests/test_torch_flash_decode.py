"""Port parity: paged decode attention.

The port's plain ``flash_attention_decode_paged_plain`` (what the CUDA
kernel is held against on the card) must match the JAX Pallas kernel
``repro.kernels.flash_attention.flash_attention_decode_paged`` — run in
interpret mode on the CPU, as ``tests/test_paged_kv.py`` runs it — for
every option: sq in {1, 3}, window None/24, ring ``page_base``, int8
pools with bf16 scales, and table entries >= n_pages.  Inputs are fp32
(the pools bf16 or int8), so the tolerance is fp32 summation order:
1e-5 absolute.

The kernel splits each (sequence, kv head)'s key tiles over several CTAs
and combines their partials by log-sum-exp.  The CPU tests hold that
rule: the tile shares (``_split_tiles``, the rule the kernel computes on
the card from ``pos``) cover every live tile once; the plain softmax over each share,
combined, equals the plain twin over all keys to fp32 rounding (2e-6
absolute on outputs below ~3); the split count (``paged_splits``) comes
from shapes alone, and the wrapper reads no device tensor on the host.
The dense-slot kernel (B3, ``flash_attention_decode``) splits its slot
caches the same way (``dense_splits``), and the same four rules are held
for it.
"""

import itertools
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import (
    flash_attention_decode_paged as jax_paged)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (
    NEG_INF, dense_splits, flash_attention_decode_paged,
    flash_attention_decode_paged_plain, flash_attention_decode_plain,
    paged_splits, paged_tile_pages)

torch.set_num_threads(2)

TOL = 1e-5

B, HQ, HKV, D = 3, 8, 2, 32
N_PAGES, PAGE = 12, 8


def _inputs(variant, sq, seed, nb=None, n_pages=N_PAGES, pos=None):
    rng = np.random.default_rng(seed)
    nb = nb or (4 if variant == "ring" else 6)
    shape = (n_pages, HKV, PAGE, D)
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
    bt = np.stack([rng.permutation(n_pages)[:nb] for _ in range(B)]
                  ).astype(np.int32)
    pos = np.asarray(pos or [5, 21, nb * PAGE - sq], np.int32)
    base = None
    if variant == "unalloc":
        live = (pos + sq - 1) // PAGE
        bt = np.where(np.arange(nb)[None, :] > live[:, None], n_pages + 3,
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


# --- split-KV: the rule the kernel follows ---------------------------------------------


def _split_tiles(split, n_split, pos, sq, n_blocks, page, window=None,
                 ring=False):
    """The tiles [lo, hi) that CTA ``split`` of ``n_split`` takes, as
    ``csrc/flash_decode_paged.cu`` computes it from ``pos``: an even share
    of the tiles that can hold a live key (flat table: from the window's
    first key to pos + sq - 1; ring: the whole table, each page then read
    or skipped by its base).  A tile is ``paged_tile_pages(page)`` table
    entries."""
    tp = paged_tile_pages(page)
    tile = tp * page
    n_tiles = -(-n_blocks // tp)
    lo, hi = 0, n_tiles
    if not ring:
        hi = min(n_tiles, max(pos + sq - 1, 0) // tile + 1)
        if window is not None and pos - window + 1 > 0:
            lo = min(hi, (pos - window + 1) // tile)
    per = -(-(hi - lo) // n_split)
    first = lo + split * per
    return first, min(hi, first + per)


def _live_entries(pos, sq, n_blocks, page, window, base):
    """Table entries whose page the kernel reads (its page rule)."""
    live = []
    for j in range(n_blocks):
        start = base[j] if base is not None else j * page
        ok = start <= pos + sq - 1
        if base is not None:
            ok = ok and start >= 0
        if window is not None:
            ok = ok and start + page - 1 > pos - window
        if ok:
            live.append(j)
    return live


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("page", [8, 12, 16, 64, 128])
def test_split_tiles_cover_every_live_tile_once(page, ring):
    rng = np.random.default_rng(page + ring)
    tp = paged_tile_pages(page)
    for n_blocks in (1, 3, 17, 64):
        n_tiles = -(-n_blocks // tp)
        for _ in range(12):
            sq = int(rng.integers(1, 5))
            pos = int(rng.integers(0, n_blocks * page - sq + 1))
            window = (int(rng.integers(1, 3 * page)) if rng.random() < 0.5
                      else None)
            base = None
            if ring:
                cur = pos // page
                base = [(cur - ((cur - j) % n_blocks)) * page
                        for j in range(n_blocks)]
            live = {j // tp for j in _live_entries(pos, sq, n_blocks, page,
                                                   window, base)}
            for n_split in range(1, n_tiles + 3):
                seen = []
                for split in range(n_split):
                    lo, hi = _split_tiles(split, n_split, pos, sq,
                                               n_blocks, page, window, ring)
                    assert 0 <= lo and hi <= n_tiles
                    seen += range(lo, hi)
                assert len(seen) == len(set(seen)), (pos, n_split)
                assert live <= set(seen), (pos, sq, window, n_split)


def _split_partials(x, window, lo_entry, hi_entry):
    """(m, l, acc) of the plain masked softmax over the keys of each
    sequence's table entries [lo_entry[b], hi_entry[b]), per (b, hkv,
    group, sq) row: m = NEG_INF, l = 0, acc = 0 where none is valid."""
    q, kp, vp = x["q"], x["k_pages"], x["v_pages"]
    bt, pos, base = x["block_tab"], x["pos"].long(), x["page_base"]
    b, hq, sq, d = q.shape
    n_pages, hkv, page, _ = kp.shape
    nb = bt.shape[1]
    bt = bt.long().clamp(0, n_pages - 1)
    kd, vd = kp[bt].float(), vp[bt].float()          # (b, nb, hkv, page, d)
    if x["k_scale_pages"] is not None:
        kd = kd * x["k_scale_pages"][bt].float()
        vd = vd * x["v_scale_pages"][bt].float()
    S = nb * page
    kd = kd.transpose(1, 2).reshape(b, hkv, S, d)
    vd = vd.transpose(1, 2).reshape(b, hkv, S, d)
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d) / np.sqrt(d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kd)
    start = (base.long() if base is not None
             else (torch.arange(nb) * page).expand(b, nb))
    active = start <= (pos + sq - 1)[:, None]
    if base is not None:
        active &= start >= 0
    if window is not None:
        active &= start + page - 1 > (pos - window)[:, None]
    entry = torch.arange(nb)[None, :]
    active &= (entry >= lo_entry[:, None]) & (entry < hi_entry[:, None])
    kpos = (start[:, :, None] + torch.arange(page)).reshape(b, S)
    qpos = pos[:, None] + torch.arange(sq)
    valid = (kpos[:, None, :] <= qpos[:, :, None]) \
        & active.repeat_interleave(page, dim=1)[:, None, :]
    if base is not None:
        valid &= (kpos >= 0)[:, None, :]
    if window is not None:
        valid &= kpos[:, None, :] > qpos[:, :, None] - window
    valid = valid[:, None, None]                      # (b, 1, 1, sq, S)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    return m, p.sum(-1), torch.einsum("bhgqk,bhkd->bhgqd", p, vd)


def _combine(parts):
    """o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s; 0 where every
    l_s is 0 (the combine kernel's rule)."""
    m = torch.stack([p[0] for p in parts])
    M = m.amax(dim=0)
    w = torch.exp(m - M)
    num = sum(wi[..., None] * p[2] for wi, p in zip(w, parts))
    den = sum(wi * p[1] for wi, p in zip(w, parts))
    return num / torch.where(den == 0, torch.ones_like(den), den)[..., None]


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("variant", ["flat", "int8", "ring", "empty"])
def test_split_partials_combine_to_the_plain_twin(variant, sq, window):
    """The plain softmax over each CTA's share of the tiles, combined by
    log-sum-exp, is the plain twin over all keys; shares with no live key
    weigh 0, and a row empty in every share writes 0."""
    ring = variant in ("ring", "empty")
    if ring:
        x = _torch(_inputs("ring", sq, seed=sq + 40))
        if variant == "empty":          # no page ever written
            x["page_base"] = torch.full_like(x["page_base"], -PAGE)
    else:
        # 24 entries of 8 keys: three 64-key tiles, the live ones ending
        # at each sequence's position.
        x = _torch(_inputs(variant, sq, seed=sq + 50, nb=24, n_pages=80,
                           pos=[5, 100, 190 - sq]))
    plain = flash_attention_decode_paged_plain(**x, window=window)
    b, hq, _, d = plain.shape
    nb = x["block_tab"].shape[1]
    tp = paged_tile_pages(PAGE)
    for n_split in (1, 2, 3, 5):
        parts = []
        for split in range(n_split):
            lo, hi = zip(*(_split_tiles(
                split, n_split, int(p), sq, nb, PAGE, window, ring)
                for p in x["pos"].tolist()))
            parts.append(_split_partials(x, window, torch.tensor(lo) * tp,
                                         torch.tensor(hi) * tp))
        got = _combine(parts).reshape(b, hq, sq, d)
        assert torch.isfinite(got).all()
        assert (got - plain).abs().max() <= 2e-6, n_split
        if variant == "empty":
            assert torch.count_nonzero(got) == 0


def test_split_count_comes_from_shapes_alone():
    """Two CTAs per SM at least where the table has the tiles, at most one
    split per tile, never fewer than one."""
    assert paged_splits(8, 8, 64, 16, 132) == 5      # 320 CTAs
    assert paged_splits(32, 8, 256, 16, 132) == 2    # 512 CTAs
    assert paged_splits(1, 8, 256, 16, 132) == 33
    assert paged_splits(8, 8, 4, 16, 132) == 1       # one tile
    assert paged_splits(64, 8, 64, 16, 132) == 1     # 512 CTAs unsplit
    for b, hkv, nb, page in itertools.product((1, 3, 8, 40), (1, 2, 8),
                                              (1, 5, 64, 300),
                                              (8, 16, 64, 256)):
        n_tiles = -(-nb // paged_tile_pages(page))
        n = paged_splits(b, hkv, nb, page, 132)
        assert 1 <= n <= n_tiles
        assert b * hkv * n >= 2 * 132 or n == n_tiles


def test_wrapper_reads_no_device_tensor_on_the_host(monkeypatch):
    """The CUDA path checks shapes, dtypes and pointers only: with meta
    tensors, which hold no data (any read of pos or the table raises), it
    reaches the launch, with the split count of the shapes and fp32
    scratch for the partials."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    scratch = []
    empty = torch.empty

    def spy_empty(*args, **kw):
        t = empty(*args, **kw)
        scratch.append(t)
        return t

    monkeypatch.setattr(fa, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(fa, "_kernel", lambda: launch)
    monkeypatch.setattr(fa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    b, hq, hkv, sq, d, page, nb = 1, 8, 2, 3, 32, 8, 64
    meta = dict(device="meta")
    x = dict(q=torch.zeros((b, hq, sq, d), **meta),
             k_pages=torch.zeros((70, hkv, page, d), dtype=torch.int8, **meta),
             v_pages=torch.zeros((70, hkv, page, d), dtype=torch.int8, **meta),
             block_tab=torch.zeros((b, nb), dtype=torch.int32, **meta),
             pos=torch.zeros((b,), dtype=torch.int32, **meta),
             k_scale_pages=torch.zeros((70, hkv, page, 1),
                                       dtype=torch.bfloat16, **meta),
             v_scale_pages=torch.zeros((70, hkv, page, 1),
                                       dtype=torch.bfloat16, **meta))
    monkeypatch.setattr(fa.torch, "empty", spy_empty)
    before = fa.flash_attention_decode_paged.launches
    out = fa.flash_attention_decode_paged(**x, window=24)
    assert out.device.type == "meta" and out.shape == (b, hq, sq, d)
    assert len(calls) == 1
    assert fa.flash_attention_decode_paged.launches == before + 1
    n_split = paged_splits(b, hkv, nb, page, 132)
    assert n_split == 8 and calls[0][19] == n_split
    rows = sq * hq // hkv
    assert [tuple(t.shape) for t in scratch] == [
        (b, hkv, n_split, rows, d), (b, hkv, n_split, rows, 2)]
    assert all(t.dtype == torch.float32 for t in scratch)


# --- dense-slot split-KV (kernel B3): the rule the kernel follows ----------------------


def _dense_split_tiles(split, n_split, pos, S, window=None, ring=False,
                       tile=fa.DENSE_TILE_KEYS):
    """The 64-key tiles [lo, hi) that CTA ``split`` of ``n_split`` takes,
    as ``csrc/flash_decode.cu`` computes it from ``pos``: an even share of
    the tiles that can hold a live key (no window: [0, pos]; band: from
    the window's first key to pos; ring: all once pos >= window), clamped
    to the cache."""
    n_tiles = -(-S // tile)
    lo, hi = 0, n_tiles
    if not (ring and pos >= window):
        hi = 0 if pos < 0 else min(n_tiles, pos // tile + 1)
        if not ring and window is not None and pos - window + 1 > 0:
            lo = min(hi, (pos - window + 1) // tile)
    per = -(-(hi - lo) // n_split)
    first = lo + split * per
    return first, min(hi, first + per)


def _dense_valid(pos, S, window, ring):
    kpos = torch.arange(S)
    if ring:
        return (kpos <= pos) | (pos >= window)
    valid = kpos <= pos
    if window is not None:
        valid &= kpos > pos - window
    return valid


@pytest.mark.parametrize("mode", ["flat", "band", "ring"])
def test_dense_split_tiles_cover_every_live_tile_once(mode):
    """Every tile holding a live key is taken by exactly one split, for
    every split count up to the tile count and past it, positions past S
    included (a finished slot keeps decoding at pos >= S)."""
    rng = np.random.default_rng(len(mode))
    tile = fa.DENSE_TILE_KEYS
    for S in (1, 40, 64, 65, 256, 1000, 4096):
        n_tiles = -(-S // tile)
        for _ in range(10):
            window = ring = None
            if mode == "band":
                window = int(rng.integers(1, 2 * S + 2))
            if mode == "ring":
                window, ring = S, True
            pos = int(rng.integers(0, 3 * S + 2))
            valid = _dense_valid(pos, S, window, bool(ring))
            live = {int(j) // tile for j in torch.nonzero(valid).flatten()}
            for n_split in range(1, n_tiles + 3):
                seen = []
                for split in range(n_split):
                    lo, hi = _dense_split_tiles(split, n_split, pos, S,
                                                window, bool(ring))
                    assert 0 <= lo and hi <= n_tiles
                    seen += range(lo, hi)
                assert len(seen) == len(set(seen)), (S, pos, n_split)
                assert live <= set(seen), (S, pos, window, n_split)


def _dense_partials(x, window, ring, lo_key, hi_key):
    """(m, l, acc) of the plain masked softmax over each slot's keys in
    [lo_key[b], hi_key[b]), per (b, hkv, group) row: m = NEG_INF, l = 0,
    acc = 0 where none is valid."""
    q, k, v, pos = x["q"], x["k"], x["v"], x["pos"].long()
    b, hq, _, d = q.shape
    _, hkv, S, _ = k.shape
    qg = q.float().reshape(b, hkv, hq // hkv, d) / np.sqrt(d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float())
    valid = torch.stack([_dense_valid(int(p), S, window, ring)
                         for p in pos])
    kpos = torch.arange(S)[None, :]
    valid &= (kpos >= lo_key[:, None]) & (kpos < hi_key[:, None])
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    return m, p.sum(-1), torch.einsum("bhgk,bhkd->bhgd", p, v.float())


@pytest.mark.parametrize("case", ["flat", "band", "ring", "pos-past-S",
                                  "pos-0-1"])
def test_dense_split_partials_combine_to_the_plain_twin(case):
    """The plain softmax over each CTA's share of the tiles, combined by
    log-sum-exp, is the plain twin over all keys; shares with no live key
    weigh 0."""
    rng = np.random.default_rng(7)
    b, hq, hkv, d, S = 4, 6, 2, 32, 300
    pos = {"flat": [5, 64, 200, 299], "band": [5, 64, 200, 299],
           "ring": [5, 299, 300, 1000], "pos-past-S": [299, 300, 512, 9999],
           "pos-0-1": [0, 1, 0, 1]}[case]
    window = {"band": 100, "ring": S}.get(case)
    ring = case == "ring"
    x = dict(q=torch.from_numpy(rng.standard_normal((b, hq, 1, d)).astype(
                 np.float32)),
             k=torch.from_numpy(rng.standard_normal((b, hkv, S, d)).astype(
                 np.float32)),
             v=torch.from_numpy(rng.standard_normal((b, hkv, S, d)).astype(
                 np.float32)),
             pos=torch.tensor(pos, dtype=torch.int32))
    plain = flash_attention_decode_plain(**x, window=window, ring=ring)
    tile = fa.DENSE_TILE_KEYS
    for n_split in (1, 2, 3, 5):
        parts = []
        for split in range(n_split):
            lo, hi = zip(*(_dense_split_tiles(split, n_split, p, S, window,
                                              ring) for p in pos))
            parts.append(_dense_partials(x, window, ring,
                                         torch.tensor(lo) * tile,
                                         torch.tensor(hi) * tile))
        got = _combine(parts).reshape(b, hq, 1, d)
        assert torch.isfinite(got).all()
        assert (got - plain).abs().max() <= 2e-6, n_split


def test_dense_split_count_comes_from_shapes_alone():
    """Two CTAs per SM at least where the cache has the tiles, at most one
    split per 64-key tile, never fewer than one."""
    assert dense_splits(8, 8, 1024, 132) == 5      # main: 320 CTAs
    assert dense_splits(32, 8, 4096, 132) == 2     # long: 512 CTAs
    assert dense_splits(8, 32, 1024, 132) == 2     # zamba2's shared block
    assert dense_splits(1, 8, 4096, 132) == 33
    assert dense_splits(1, 1, 4096, 132) == 64     # one split per tile
    assert dense_splits(3, 8, 48, 132) == 1        # one tile
    for b, hkv, S in itertools.product((1, 3, 8, 40), (1, 2, 8, 32),
                                       (1, 48, 64, 1000, 4096)):
        n_tiles = -(-S // fa.DENSE_TILE_KEYS)
        n = dense_splits(b, hkv, S, 132)
        assert 1 <= n <= n_tiles
        assert b * hkv * n >= 2 * 132 or n == n_tiles


def test_dense_wrapper_reads_no_device_tensor_on_the_host(monkeypatch):
    """With meta tensors (any read of pos raises), the CUDA path of B3's
    wrapper reaches the launch with the split count of the shapes and
    fp32 scratch for the partials."""
    calls, scratch = [], []
    empty = torch.empty

    def spy_empty(*args, **kw):
        t = empty(*args, **kw)
        scratch.append(t)
        return t

    monkeypatch.setattr(fa, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(fa, "_dense_kernel",
                        lambda: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(fa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    b, hq, hkv, S, d = 8, 24, 8, 1024, 128
    meta = dict(device="meta", dtype=torch.bfloat16)
    x = dict(q=torch.zeros((b, hq, 1, d), **meta),
             k=torch.zeros((b, hkv, S, d), **meta),
             v=torch.zeros((b, hkv, S, d), **meta),
             pos=torch.zeros((b,), dtype=torch.int32, device="meta"))
    monkeypatch.setattr(fa.torch, "empty", spy_empty)
    before = fa.flash_attention_decode.launches
    out = fa.flash_attention_decode(**x, window=256)
    assert out.device.type == "meta" and out.shape == (b, hq, 1, d)
    assert len(calls) == 1
    assert fa.flash_attention_decode.launches == before + 1
    n_split = dense_splits(b, hkv, S, 132)
    assert n_split == 5 and calls[0][12] == n_split
    assert [tuple(t.shape) for t in scratch] == [
        (b, hkv, n_split, hq // hkv, d), (b, hkv, n_split, hq // hkv, 2)]
    assert all(t.dtype == torch.float32 for t in scratch)
