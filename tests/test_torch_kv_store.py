"""Port parity: B2's quantize-and-store entry and the int8 cache writes.

``kv_quantize_store`` quantizes one layer's K and V rows and writes them,
values and bf16 scales, straight into their cache rows in one launch;
rows whose destination lies outside the leaf are dropped.  Its plain twin
``kv_quantize_store_plain`` (what the CUDA kernel is held against, bit
for bit, on the card) must be BIT-EQUAL to what the reference writes:

* a dense slot cache: ``_kv_quantize`` followed by
  ``lax.dynamic_update_slice_in_dim`` (the batcher vmaps it over slots),
  with the slot on a ring (``pos % window``) and past the end, where the
  reference clamps the start to ``S - 1``;
* a page pool: ``.at[wp, :, wo].set(..., mode="drop")`` with rows
  dropped for unallocated pages, positions past the table, a padded
  chunk tail (``last_idx``) and read-only positions (``cache_offset``).

Then the model path: the port's int8 paged chunk and decode steps (with
and without ``decode_flash``) against the JAX package on bridged
weights, with logits to ``LOGIT_TOL`` and the pools equal but for
near-ties (as ``tests/test_torch_kv_quant.py`` holds the dense int8
decode), one launch of the store per layer and step, the wrapper's
launch with no host read of a device tensor (meta tensors), and a
Python mirror of the kernel's lane groups (which lanes load which 16-byte
vectors of which rows, the butterfly max within a group, the drop test)
bit-equal to the twin for every plan the kernel has.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.kernels import kv_quant as kq
from repro_torch.kernels.kv_quant import (kv_quant_plan, kv_quantize_plain,
                                          kv_quantize_store,
                                          kv_quantize_store_plain,
                                          kv_store_rows)
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry

torch.set_num_threads(2)

# as tests/test_torch_kv_quant.py: logits read through int8 caches whose
# fp32 K/V may differ in the last bits between the frameworks.
LOGIT_TOL = 1e-3


def _rows(rng, shape):
    """Values of widely varying scale per row, with exact .5 quotients in
    the first row (amax 127 gives scale 1.0 exactly) and an all-zero row."""
    x = (rng.standard_normal(shape)
         * rng.uniform(0.01, 10.0, shape[:-1] + (1,))).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    if shape[-1] >= 8:
        flat[0, :8] = [2.5, -3.5, 0.5, 1.5, -0.5, 127.0, 4.5, -126.5]
    flat[1] = 0.0
    return x


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor (bf16 by bits)."""
    jx = jnp.asarray(x) if dtype == "float32" else \
        jnp.asarray(x).astype(jnp.bfloat16)
    return jx, tparams.params_from_numpy({"x": np.asarray(jx)}, "cpu")["x"]


def _leaves(rng, shape):
    """Random int8 leaves and bf16 scale leaves (as written before), as
    numpy (scales in fp32, bf16-representable)."""
    q = {n: rng.integers(-127, 128, shape).astype(np.int8) for n in "kv"}
    s = {n + "_scale": np.asarray(jnp.asarray(
        rng.uniform(0.001, 0.1, shape[:-1] + (1,)), jnp.bfloat16), np.float32)
         for n in "kv"}
    return {**q, **s}


def _torch_leaves(leaves):
    return {n: torch.from_numpy(a.copy()) if a.dtype == np.int8
            else torch.from_numpy(a).bfloat16() for n, a in leaves.items()}


def _assert_leaves_equal(got, want):
    for name, w in want.items():
        g = got[name]
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w, g.dtype), err_msg=name)


# --- (a) the twin against the reference's writes -----------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,pos,window", [
    ("in range", [0, 5, 7], None),
    ("ring", [3, 9, 17], 8),
    ("clamped to S - 1", [7, 8, 30], None),
])
def test_store_plain_bit_equal_to_reference_dense_update(dtype, case, pos,
                                                         window):
    b, hkv, S, hd = 3, 2, 8, 32
    rng = np.random.default_rng(len(case))
    leaves = _leaves(rng, (b, hkv, S, hd))
    jk, tk = _pair(_rows(rng, (b, hkv, 1, hd)), dtype)
    jv, tv = _pair(_rows(rng, (b, hkv, 1, hd)), dtype)
    jpos = jnp.asarray(pos, jnp.int32)
    jslot = jpos % window if window else jpos     # the reference clamps
    update = jax.vmap(lambda c, u, s: lax.dynamic_update_slice_in_dim(
        c, u, s, 1))
    want = dict(leaves)
    for name, x in (("k", jk), ("v", jv)):
        q, s = jlayers._kv_quantize(x)
        want[name] = update(jnp.asarray(leaves[name]), q, jslot)
        want[name + "_scale"] = update(
            jnp.asarray(leaves[name + "_scale"], jnp.bfloat16), s, jslot)

    got = _torch_leaves(leaves)
    tpos = torch.tensor(pos)
    slot = (tpos % window if window else tpos).clamp(max=S - 1)
    kv_quantize_store_plain(tk[:, :, 0], tv[:, :, 0], got["k"], got["v"],
                            got["k_scale"], got["v_scale"],
                            kv_store_rows(torch.arange(b), slot, hkv, S))
    _assert_leaves_equal(got, want)


def _reference_paged_write(pages, kc, vc, block_tab, pos, last_idx,
                           cache_offset):
    """The reference's int8 append (``attention_apply_paged``, the
    non-ring branch), on (b, s, hkv, hd) K/V."""
    n_pages, _, page, _ = pages["k"].shape
    b, s = kc.shape[:2]
    n_blocks = block_tab.shape[1]
    positions = pos[:, None] + jnp.arange(s)
    logical = positions // page
    tab_idx = jnp.minimum(logical, n_blocks - 1)
    keep = logical < n_blocks
    keep &= jnp.arange(s)[None, :] <= last_idx[:, None]
    keep &= positions >= cache_offset[:, None]
    wp = jnp.take_along_axis(block_tab, tab_idx, axis=1)
    wp = jnp.where(keep, wp, n_pages)
    wo = positions % page
    out = {}
    for name, x in (("k", kc), ("v", vc)):
        q, sc = jlayers._kv_quantize(x)
        out[name] = jnp.asarray(pages[name]).at[wp, :, wo].set(
            q, mode="drop")
        out[name + "_scale"] = jnp.asarray(
            pages[name + "_scale"], jnp.bfloat16).at[wp, :, wo].set(
            sc, mode="drop")
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_plain_bit_equal_to_reference_paged_drop(dtype):
    """Rows dropped for an unallocated page (id n_pages), positions past
    the table, a padded chunk tail and read-only positions."""
    n_pages, hkv, page, hd = 7, 2, 4, 32
    b, s = 3, 6
    rng = np.random.default_rng(5)
    leaves = _leaves(rng, (n_pages, hkv, page, hd))
    jk, tk = _pair(_rows(rng, (b, s, hkv, hd)), dtype)
    jv, tv = _pair(_rows(rng, (b, s, hkv, hd)), dtype)
    bt = np.asarray([[3, 0, n_pages], [5, 1, 6], [2, 4, n_pages]], np.int32)
    pos = np.asarray([2, 7, 5], np.int32)           # row 1 runs past the table
    last_idx = np.asarray([5, 5, 2], np.int32)      # row 2: padded tail
    cache_offset = np.asarray([0, 9, 0], np.int32)  # row 1: read-only prefix
    want = _reference_paged_write(leaves, jk, jv, jnp.asarray(bt),
                                  jnp.asarray(pos), jnp.asarray(last_idx),
                                  jnp.asarray(cache_offset))
    got = _torch_leaves(leaves)
    rows = tlayers.paged_store_rows(
        torch.from_numpy(bt), torch.from_numpy(pos), s, page, n_pages, hkv,
        torch.from_numpy(last_idx), torch.from_numpy(cache_offset))
    assert rows.shape == (b, s, hkv) and rows.dtype == torch.int64
    dropped = int((rows < 0).sum())
    assert 0 < dropped < rows.numel()
    kv_quantize_store_plain(tk, tv, got["k"], got["v"], got["k_scale"],
                            got["v_scale"], rows)
    _assert_leaves_equal(got, want)
    # the kept rows are exactly paged_write_index's
    rb, rs, wp, wo = tlayers.paged_write_index(
        torch.from_numpy(bt), torch.from_numpy(pos), s, page, n_pages,
        torch.from_numpy(last_idx), torch.from_numpy(cache_offset))
    assert torch.equal(rows[rb, rs, 0], (wp * hkv) * page + wo)
    assert len(rb) * hkv == rows.numel() - dropped


def test_store_rows_layout():
    """Flat rows of a (lead, heads, slots, d) leaf: head-major within a
    lead, -1 where not kept; negative and too-large rows are dropped by
    the twin (and the kernel)."""
    lead, slot = torch.tensor([[2, 0]]), torch.tensor([[3, 1]])
    keep = torch.tensor([[True, False]])
    rows = kv_store_rows(lead, slot, 3, 5, keep)
    assert rows.tolist() == [[[33, 38, 43], [-1, -1, -1]]]
    leaf = torch.zeros((2, 1, 2, 8), dtype=torch.int8)
    scale = torch.zeros((2, 1, 2, 1), dtype=torch.bfloat16)
    x = torch.ones((3, 8))
    kv_quantize_store_plain(x, x, leaf, leaf.clone(), scale, scale.clone(),
                            torch.tensor([-1, 4, 2]))
    assert leaf.view(-1, 8)[2].tolist() == [127] * 8
    assert int(torch.count_nonzero(leaf)) == 8


# --- (b) the model path against the JAX package ------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jsmoke(jconfigs.get("minitron-4b")),
                               kv_cache_dtype="int8", kv_page_size=8)
    tcfg = dataclasses.replace(tsmoke(tconfigs.get("minitron-4b")),
                               kv_cache_dtype="int8", kv_page_size=8)
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return jcfg, tcfg, jp, tp


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("decode_flash", [True, False])
def test_int8_paged_chunk_and_decode_match_jax(model, monkeypatch,
                                               decode_flash):
    """Two sequences in two chunks each (a padded tail, a read-only
    prefix, an unallocated page) and three decode steps through int8
    pools: logits to LOGIT_TOL and pools equal to the reference's except
    at near-ties (one int8 step), scales to one bf16 ulp; one store per
    layer and step, and no separate quantize on the append."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, decode_flash=decode_flash)
    tcfg = dataclasses.replace(tcfg, decode_flash=decode_flash)
    page, n_pages = 8, 10
    jpools = jparams.init_params(jregistry.paged_cache_decls(jcfg, n_pages,
                                                             page))
    tpools = tparams.init_params(tregistry.paged_cache_decls(tcfg, n_pages,
                                                             page),
                                 device="cpu")
    bt = np.asarray([[7, 2, 9, n_pages], [0, 5, 3, 8]], np.int32)
    stores = _count_calls(monkeypatch, tlayers, "kv_quantize_store")
    quants = _count_calls(monkeypatch, tlayers, "kv_quantize")
    rng = np.random.default_rng(3)
    chunks = [((0, 0), (7, 7), (0, 0)), ((8, 8), (7, 4), (10, 0))]
    for c, (pos0, last, off) in enumerate(chunks):
        tok = rng.integers(0, 512, (2, 8)).astype(np.int32)
        args = [np.asarray(a, np.int32) for a in (pos0, last, off)]
        jl, jpools = jregistry.forward(
            jcfg, jp, {"tokens": jnp.asarray(tok)}, mode="chunk",
            cache={"pages": jpools, "block_tab": {"kv": jnp.asarray(bt)}},
            pos=jnp.asarray(args[0]), last_pos=jnp.asarray(args[1]),
            cache_offset=jnp.asarray(args[2]))
        tl, tpools = tregistry.forward(
            tcfg, tp, {"tokens": torch.from_numpy(tok).long()}, mode="chunk",
            cache={"pages": tpools, "block_tab": {"kv": torch.from_numpy(bt)}},
            pos=torch.from_numpy(args[0]), last_pos=torch.from_numpy(args[1]),
            cache_offset=torch.from_numpy(args[2]))
        assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) \
            <= LOGIT_TOL, f"chunk {c}"
    assert len(stores) == 2 * tcfg.n_layers and not quants
    pos = np.asarray([16, 13], np.int32)
    for i, step in enumerate(rng.integers(0, 512, (3, 2))):
        jl, jpools = jregistry.forward(
            jcfg, jp, {"tokens": jnp.asarray(step[:, None])}, mode="decode",
            cache={"pages": jpools, "block_tab": {"kv": jnp.asarray(bt)}},
            pos=jnp.asarray(pos + i))
        tl, tpools = tregistry.forward(
            tcfg, tp, {"tokens": torch.from_numpy(step[:, None]).long()},
            mode="decode",
            cache={"pages": tpools, "block_tab": {"kv": torch.from_numpy(bt)}},
            pos=torch.from_numpy(pos + i))
        assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) \
            <= LOGIT_TOL, f"decode step {i}"
    assert len(stores) == 5 * tcfg.n_layers
    # without the kernel a decode step also attends its own rows
    # pool-rounded, through the separate quantize (K and V).
    assert len(quants) == (0 if decode_flash else 3 * 2 * tcfg.n_layers)
    for leaf in ("k", "v"):
        t, j = tpools["kv"][leaf], jpools["kv"][leaf]
        diff = np.abs(t.numpy().astype(int) - np.asarray(j))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        ts = tpools["kv"][leaf + "_scale"].float().numpy()
        sdiff = np.abs(ts - np.asarray(jpools["kv"][leaf + "_scale"],
                                       np.float32))
        assert np.all(sdiff <= 2.0 ** -8 * np.abs(ts))
    # the read-only prefix (row 0, positions 8 and 9) was never written.
    page_of_8 = bt[0, 1]
    assert not tpools["kv"]["k"][:, page_of_8, :, :2].any()


def test_int8_dense_decode_stores_once_per_layer(model, monkeypatch):
    """A dense int8 decode step writes K and V through one store per
    layer and runs no separate quantize; the slots it writes equal a
    quantize of the same rows (``tests/test_torch_kv_quant.py`` holds the
    same path against the JAX package)."""
    _, tcfg, _, tp = model
    cache = tparams.init_params(tregistry.cache_decls(tcfg, 2, 16),
                                device="cpu")
    stores = _count_calls(monkeypatch, tlayers, "kv_quantize_store")
    quants = _count_calls(monkeypatch, tlayers, "kv_quantize")
    pos = torch.tensor([3, 20])                     # 20 clamps to slot 15
    tregistry.forward(tcfg, tp, {"tokens": torch.tensor([[5], [9]])},
                      mode="decode", cache=cache, pos=pos)
    assert len(stores) == tcfg.n_layers and not quants
    written = cache["k"][:, torch.arange(2), :, torch.tensor([3, 15])]
    assert written.any(dim=-1).all()
    untouched = cache["k"].clone()
    untouched[:, torch.arange(2), :, torch.tensor([3, 15])] = 0
    assert not untouched.any()


# --- (c) no host read of a device tensor -------------------------------------------


def test_store_wrapper_launches_from_shapes_alone(monkeypatch):
    """The CUDA path checks shapes, dtypes and pointers only: with meta
    tensors, which hold no data, it reaches the launch with the rows,
    the destination rows and the plan of the shapes."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(kq, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(kq, "_kernels", lambda: (None, launch, None))
    monkeypatch.setattr(kq, "sm_count", lambda index: 132)
    monkeypatch.setattr(kq.torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    meta = dict(device="meta")
    b, hkv, S, d = 8, 8, 1024, 128
    k = torch.zeros((b, hkv, d), dtype=torch.bfloat16, **meta)
    leaf = torch.zeros((b, hkv, S, d), dtype=torch.int8, **meta)
    scale = torch.zeros((b, hkv, S, 1), dtype=torch.bfloat16, **meta)
    rows = torch.zeros((b, hkv), dtype=torch.int64, **meta)
    before = kv_quantize_store.launches
    kv_quantize_store(k, k, leaf, leaf, scale, scale, rows)
    assert kv_quantize_store.launches == before + 1 and len(calls) == 1
    n, n_dst, dd, bf16, plan = calls[0][7:12]
    assert (n, n_dst, dd, bf16) == (b * hkv, b * hkv * S, d, 1)
    assert tuple(plan) == kv_quant_plan(2 * b * hkv, d, 2, 132) \
        == (16, 1, 64)
    k36 = torch.zeros((b, hkv, 36), dtype=torch.bfloat16, **meta)
    leaf36 = torch.zeros((b, hkv, S, 36), dtype=torch.int8, **meta)
    with pytest.raises(ValueError, match="multiple of 8"):
        kv_quantize_store(k36, k36, leaf36, leaf36, scale, scale, rows)
    with pytest.raises(ValueError, match="int64"):
        kv_quantize_store(k, k, leaf, leaf, scale, scale, rows.int())
    with pytest.raises(ValueError, match="scale leaves"):
        kv_quantize_store(k, k, leaf, leaf, scale[:, :, :8], scale, rows)
    assert len(calls) == 1


def test_store_wrapper_cpu_twin_and_no_fallback():
    """CPU tensors run the twin and launch nothing; tensors on another
    device go to the kernel or raise (meta tensors: raise)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_rows(rng, (4, 32)))
    leaf = torch.zeros((6, 32), dtype=torch.int8)
    scale = torch.zeros((6, 1), dtype=torch.bfloat16)
    before = kv_quantize_store.launches
    kv_quantize_store(x, -x, leaf, leaf, scale, scale,
                      torch.tensor([5, -1, 0, 3]))
    assert kv_quantize_store.launches == before
    q, s = kv_quantize_plain(-x)     # v written last, into the same leaf
    assert torch.equal(leaf[[5, 0, 3]], q[[0, 2, 3]])
    assert torch.equal(scale[[5, 0, 3]], s[[0, 2, 3]])
    with pytest.raises(ValueError, match="one CUDA device"):
        kv_quantize_store(x.to("meta"), x, leaf, leaf, scale, scale,
                          torch.tensor([0, 1, 2, 3]))


# --- (d) the kernel's lane groups, mirrored --------------------------------------


def _mirror_store(k, v, k_dst, v_dst, ks_dst, vs_dst, dst_row, plan):
    """The kernel's order in numpy, for ``plan`` = (G, NV, threads): the
    grid's warps in order, lane group g of warp w on row w * 32/G + g
    (rows of k, then of v); lane l loads vectors j * G + l (j < NV) of
    its row, zero past the row, takes its own max, and the group
    combines by the butterfly (lane ^ off, off = G/2 .. 1); a row whose
    destination lies outside [0, n_dst) stores nothing."""
    lanes, nv, threads = plan
    d = k.shape[-1]
    vec = 16 // k.element_size()
    groups = 32 // lanes
    src = [x.reshape(-1, d).float().numpy() for x in (k, v)]
    n = src[0].shape[0]
    total, nvec = 2 * n, d // vec
    n_dst = k_dst.numel() // d
    dst = dst_row.reshape(-1).numpy()
    q_out = [t.view(-1, d) for t in (k_dst, v_dst)]
    s_out = [t.view(-1, 1) for t in (ks_dst, vs_dst)]
    rows_per_cta = threads // 32 * groups
    warps = -(-total // rows_per_cta) * (threads // 32)
    seen = np.zeros(total, int)
    for warp in range(warps):
        for g in range(groups):
            t = warp * groups + g
            if t >= total:
                continue
            seen[t] += 1
            which, i = divmod(t, n)
            row = src[which][i]
            vals = np.zeros((lanes, nv, vec), np.float32)
            for l in range(lanes):
                for j in range(nv):
                    c = j * lanes + l
                    if c < nvec:
                        vals[l, j] = row[c * vec:(c + 1) * vec]
            lane_max = [np.float32(np.abs(vals[l]).max())
                        for l in range(lanes)]
            off = lanes // 2
            while off:
                lane_max = [max(lane_max[l], lane_max[l ^ off])
                            for l in range(lanes)]
                off //= 2
            assert len(set(lane_max)) == 1           # the group agrees
            scale = np.float32(max(lane_max[0], np.float32(1e-6))) \
                / np.float32(127.0)
            if not 0 <= dst[i] < n_dst:
                continue
            out = np.zeros(d, np.int8)
            for l in range(lanes):
                for j in range(nv):
                    c = j * lanes + l
                    if c < nvec:
                        out[c * vec:(c + 1) * vec] = np.clip(
                            np.rint(vals[l, j] / scale), -127,
                            127).astype(np.int8)
            q_out[which][dst[i]] = torch.from_numpy(out)
            s_out[which][dst[i]] = torch.tensor(float(scale)).bfloat16()
    assert np.all(seen == 1)                          # each row once


@pytest.mark.parametrize("d,dtype", [
    (8, torch.bfloat16), (4, torch.float32), (16, torch.bfloat16),
    (32, torch.bfloat16), (64, torch.bfloat16), (96, torch.bfloat16),
    (128, torch.bfloat16), (128, torch.float32), (256, torch.bfloat16),
    (512, torch.bfloat16), (512, torch.float32), (384, torch.float32),
])
@pytest.mark.parametrize("n_sm", [132, 1])
def test_lane_group_mirror_bit_equal_to_twin(d, dtype, n_sm):
    """The plan for few rows (132 SMs: one vector a lane, CTAs of 2 warps)
    and for many (one SM: two vectors a lane, CTAs of 4 warps)."""
    rng = np.random.default_rng(d)
    n, n_dst = 37, 50
    x_bytes = torch.tensor([], dtype=dtype).element_size()
    plan = kv_quant_plan(2 * n, d, x_bytes, n_sm)
    k = torch.from_numpy(_rows(rng, (n, d))).to(dtype)
    v = torch.from_numpy(_rows(rng, (n, d))).to(dtype)
    dst = torch.from_numpy(rng.permutation(n_dst + 10)[:n] - 5)
    leaves = _torch_leaves(_leaves(rng, (n_dst, d)))
    mirror = {name: t.clone() for name, t in leaves.items()}
    kv_quantize_store_plain(k, v, leaves["k"], leaves["v"],
                            leaves["k_scale"], leaves["v_scale"], dst)
    _mirror_store(k, v, mirror["k"], mirror["v"], mirror["k_scale"],
                  mirror["v_scale"], dst, plan)
    for name in leaves:
        assert torch.equal(mirror[name], leaves[name]), name
    assert ((dst < 0) | (dst >= n_dst)).any()


# the (G, NV) pairs csrc/kv_quant.cu's dispatch has
SHIPPED_PLANS = {(1, 1), (2, 1), (4, 1), (8, 1), (16, 1), (32, 1), (1, 2),
                 (2, 2), (4, 2), (8, 2), (16, 2), (32, 2), (32, 4)}


@pytest.mark.parametrize("rows", [64, 128, 2048, 16384, 65536])
def test_plans_cover_every_head_dim(rows):
    """Every arch's head dim (and the smoke width) gets a plan the kernel
    has: lanes whose vectors cover the row, CTAs of 2 or 4 warps."""
    for d in (32, 64, 128, 192, 256, 512):
        for x_bytes in (2, 4):
            lanes, nv, threads = kv_quant_plan(rows, d, x_bytes, 132)
            assert (lanes, nv) in SHIPPED_PLANS
            assert lanes * nv * 16 >= d * x_bytes
            assert threads in (64, 128)


def test_plans_at_the_path_shapes():
    """The slot cache (a prefill's whole-cache conversion): 8 lanes of two
    vectors per bf16 row of 128 (16 per fp32 row); a decode step's K and
    V rows: one vector a lane in CTAs of two warps."""
    assert kv_quant_plan(8 * 8 * 1024, 128, 2, 132) == (8, 2, 128)
    assert kv_quant_plan(8 * 8 * 1024, 128, 4, 132) == (16, 2, 128)
    assert kv_quant_plan(2 * 8 * 8, 128, 2, 132) == (16, 1, 64)
