"""Port parity: MLA and deepseek-v2-lite (smoke width, fp32), the layer.

The same weights (JAX's ``registry.init(cfg, 0)`` carried across with
``params_from_numpy``) and the same numpy-made tokens go through both
packages: ``mla_apply`` in train, prefill and dense decode (each row at
its own position, against ``jax.vmap`` of a one-row decode), and
``mla_apply_paged`` in chunk, decode and verify, logits to
``LOGIT_TOL`` with the dense cache and the latent pools to one bf16 ulp;
the masked write that replaces the reference's ``mode="drop"`` scatter;
and ``LatentLayout``'s declarations against the reference's.  The serve
contracts on latent pages are in ``tests/test_torch_mla_serve.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import cache_layouts as jlayouts
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import cache_layouts as tlayouts
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry

torch.set_num_threads(2)

ARCH = "deepseek-v2-lite-16b"
# as tests/test_torch_model.py: fp32 logits read through bf16 caches
# whose elements may round to the neighbouring value across frameworks.
LOGIT_TOL = 1e-3
CACHE_TOL = 2.0 ** -6        # one bf16 ulp at |x| < 2


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get(ARCH))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return jcfg, tsmoke(tconfigs.get(ARCH)), jp, tp


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _diff(t, j):
    return float(np.abs(t.detach().float().numpy()
                        - np.asarray(j.astype(jnp.float32))).max())


def _bridge(tree):
    return tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), tree), "cpu")


def _leaves_close(t, j, tol=CACHE_TOL):
    for path, a in _flat(t):
        b = j
        for k in path:
            b = b[k]
        assert tuple(a.shape) == b.shape, path
        assert a.dtype == torch.bfloat16, path
        assert _diff(a, b) <= tol, path


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat(v, path + (k,))]
    return [(path, tree)]


def test_train_logits_match(model):
    jcfg, tcfg, jp, tp = model
    tok = _tokens((2, 12), 0)
    gold = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)})
    got = tregistry.forward(tcfg, tp, {"tokens": torch.from_numpy(tok).long()})
    assert got.shape == gold.shape
    assert _diff(got, gold) <= LOGIT_TOL


def test_mla_layer_matches(model):
    """One MLA layer, train and absorbed decode on a cache, at 1e-5."""
    jcfg, tcfg, jp, tp = model
    jm = jax.tree.map(lambda a: a[0], jp["blocks"]["rest"]["attn"])
    tm = tparams.tree_map(lambda _, a: a[0], tp["blocks"]["rest"]["attn"])
    x = np.random.default_rng(1).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    gold, _ = jlayers.mla_apply(jcfg, jm, jnp.asarray(x))
    got, _ = tlayers.mla_apply(tcfg, tm, torch.from_numpy(x))
    assert _diff(got, gold) < 1e-5
    cache = {"c_kv": np.random.default_rng(2).standard_normal(
        (2, 12, jcfg.kv_lora_rank)).astype(np.float32),
        "k_rope": np.random.default_rng(3).standard_normal(
        (2, 12, jcfg.qk_rope_dim)).astype(np.float32)}
    jc = {n: jnp.asarray(a, jnp.bfloat16) for n, a in cache.items()}
    tc = _bridge(jc)
    gold, jc = jlayers.mla_apply(jcfg, jm, jnp.asarray(x[:, :1]), cache=jc,
                                 pos=jnp.int32(7))
    got, tc = tlayers.mla_apply(tcfg, tm, torch.from_numpy(x[:, :1]),
                                cache=tc, pos=7)
    assert _diff(got, gold) < 1e-5
    _leaves_close(tc, jc, 0.0)


def test_prefill_then_decode_logits_match(model):
    jcfg, tcfg, jp, tp = model
    max_seq, plen = 24, 11
    tok = _tokens((2, plen), 1)
    last = np.asarray([plen - 1, plen - 3], np.int32)
    jl, jc = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)},
                               mode="prefill", cache_len=max_seq,
                               last_pos=jnp.asarray(last))
    tl, tc = tregistry.forward(tcfg, tp,
                               {"tokens": torch.from_numpy(tok).long()},
                               mode="prefill", cache_len=max_seq,
                               last_pos=torch.from_numpy(last))
    assert _diff(tl, jl) <= LOGIT_TOL
    assert set(tc) == {"first", "rest"}
    _leaves_close(tc, jc)
    for i, step in enumerate(_tokens((4, 2), 2)):
        jl, jc = jregistry.forward(jcfg, jp,
                                   {"tokens": jnp.asarray(step[:, None])},
                                   mode="decode", cache=jc,
                                   pos=jnp.int32(plen + i))
        tl, tc = tregistry.forward(tcfg, tp, {"tokens": torch.from_numpy(
            step[:, None]).long()}, mode="decode", cache=tc, pos=plen + i)
        assert _diff(tl, jl) <= LOGIT_TOL, f"decode step {i}"
    _leaves_close(tc, jc)


def test_per_row_decode_matches_vmapped_jax(model):
    """Dense slots decode every row at its own position in one batched
    step (positions ragged, one at the last slot and one past it: the
    write clamps to the last slot as dynamic_update_slice does); the
    reference vmaps a one-row decode.  Both start from the JAX prefill's
    cache, bridged; the dense-slot step gives each row its own MoE
    capacity (``row_capacity``)."""
    jcfg, tcfg, jp, tp = model
    b, plen, max_seq = 5, 6, 12
    tok = _tokens((b, plen), 4)
    _, jc = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)},
                              mode="prefill", cache_len=max_seq)
    tc = _bridge(jc)
    step = _tokens((b,), 5)
    pos = np.asarray([6, 3, 9, 11, 12], np.int32)

    def one(c1, t, p):
        lg, c1 = jregistry.forward(
            jcfg, jp, {"tokens": t[None, None]}, mode="decode",
            cache=jax.tree.map(lambda a: a[:, None], c1), pos=p)
        return lg[0, -1], jax.tree.map(lambda a: a[:, 0], c1)

    gold, jc = jax.vmap(one, in_axes=(1, 0, 0), out_axes=(0, 1))(
        jc, jnp.asarray(step), jnp.asarray(pos))
    got, tc = tregistry.forward(
        tcfg, tp, {"tokens": torch.from_numpy(step[:, None]).long()},
        mode="decode", cache=tc, pos=torch.from_numpy(pos),
        row_capacity=True)
    assert _diff(got[:, -1], gold) <= LOGIT_TOL
    _leaves_close(tc, jc)


def _pools(jcfg, tcfg, n_pages, page):
    jpools = jparams.init_params(jregistry.paged_cache_decls(jcfg, n_pages,
                                                             page))
    tpools = tparams.init_params(tregistry.paged_cache_decls(
        tcfg, n_pages, page), device="cpu")
    return jpools, tpools


def test_paged_chunk_decode_verify_match(model):
    """Two sequences prefilled in two chunks (ragged last chunk) into
    latent pages, two decode steps, then a verify span of 4: logits to
    ``LOGIT_TOL``, the latent pools to one bf16 ulp."""
    jcfg, tcfg, jp, tp = model
    page, n_pages = 8, 10
    jcfg = dataclasses.replace(jcfg, kv_page_size=page)
    tcfg = dataclasses.replace(tcfg, kv_page_size=page)
    jpools, tpools = _pools(jcfg, tcfg, n_pages, page)
    bt = np.asarray([[7, 2, 9, n_pages], [0, 5, 3, 8]], np.int32)
    jbt, tbt = {"latent": jnp.asarray(bt)}, {"latent": torch.from_numpy(bt)}
    for c, (pos0, last) in enumerate([(np.asarray([0, 0]),
                                       np.asarray([7, 7])),
                                      (np.asarray([8, 8]),
                                       np.asarray([7, 4]))]):
        tok = _tokens((2, 8), 10 + c)
        jl, jpools = jregistry.forward(
            jcfg, jp, {"tokens": jnp.asarray(tok)}, mode="chunk",
            cache={"pages": jpools, "block_tab": jbt},
            pos=jnp.asarray(pos0, jnp.int32),
            last_pos=jnp.asarray(last, jnp.int32),
            cache_offset=jnp.zeros((2,), jnp.int32))
        tl, tpools = tregistry.forward(
            tcfg, tp, {"tokens": torch.from_numpy(tok).long()}, mode="chunk",
            cache={"pages": tpools, "block_tab": tbt},
            pos=torch.from_numpy(pos0).int(),
            last_pos=torch.from_numpy(last).int(),
            cache_offset=torch.zeros(2, dtype=torch.int32))
        assert _diff(tl, jl) <= LOGIT_TOL, f"chunk {c}"
    pos = np.asarray([16, 13], np.int32)
    for i, step in enumerate(_tokens((2, 2), 20)):
        jl, jpools = jregistry.forward(
            jcfg, jp, {"tokens": jnp.asarray(step[:, None])}, mode="decode",
            cache={"pages": jpools, "block_tab": jbt},
            pos=jnp.asarray(pos + i))
        tl, tpools = tregistry.forward(
            tcfg, tp, {"tokens": torch.from_numpy(step[:, None]).long()},
            mode="decode", cache={"pages": tpools, "block_tab": tbt},
            pos=torch.from_numpy(pos + i))
        assert _diff(tl, jl) <= LOGIT_TOL, f"decode step {i}"
    span = _tokens((2, 4), 21)
    jl, jpools = jregistry.forward(
        jcfg, jp, {"tokens": jnp.asarray(span)}, mode="verify",
        cache={"pages": jpools, "block_tab": jbt}, pos=jnp.asarray(pos + 2))
    tl, tpools = tregistry.forward(
        tcfg, tp, {"tokens": torch.from_numpy(span).long()}, mode="verify",
        cache={"pages": tpools, "block_tab": tbt},
        pos=torch.from_numpy(pos + 2))
    assert tl.shape == (2, 4, tcfg.padded_vocab)
    assert _diff(tl, jl) <= LOGIT_TOL
    _leaves_close(tpools, jpools)


def test_masked_write_is_the_drop_mode_scatter(model):
    """The reference scatters every latent row and lets ``mode="drop"``
    discard page id ``n_pages``; the port writes only the kept rows.  A
    chunk with a padded tail (``last_idx``), a read-only prefix
    (``cache_offset``), positions past the table and an unallocated
    entry writes the same pages as the reference, from the same latent
    rows (one layer, inputs in bf16, so the rows are equal), and no
    other page."""
    jcfg, tcfg, jp, tp = model
    jm = jax.tree.map(lambda a: a[0], jp["blocks"]["first"]["attn"])
    tm = tparams.tree_map(lambda _, a: a[0], tp["blocks"]["first"]["attn"])
    page, n_pages = 4, 8
    base = {"c_kv": np.random.default_rng(6).standard_normal(
        (n_pages, page, jcfg.kv_lora_rank)).astype(np.float32),
        "k_rope": np.random.default_rng(7).standard_normal(
        (n_pages, page, jcfg.qk_rope_dim)).astype(np.float32)}
    jpages = {n: jnp.asarray(a, jnp.bfloat16) for n, a in base.items()}
    tpages = _bridge(jpages)
    before = tparams.tree_map(lambda _, a: a.clone(), tpages)
    # row 0: positions 2..9 over pages [3, n_pages (unallocated)], tail
    # padded after index 5, the first two positions read-only; row 1:
    # positions 6..13 over a 2-entry table (12, 13 past it).
    bt = np.asarray([[3, n_pages], [5, 1]], np.int32)
    pos = np.asarray([2, 6], np.int32)
    last = np.asarray([5, 7], np.int32)
    off = np.asarray([4, 0], np.int32)
    x = np.array(jnp.asarray(np.random.default_rng(8).standard_normal(
        (2, 8, jcfg.d_model)), jnp.bfloat16).astype(jnp.float32))
    _, jpages = jlayers.mla_apply_paged(
        jcfg, jm, jnp.asarray(x), pages=jpages, block_tab=jnp.asarray(bt),
        pos=jnp.asarray(pos), last_idx=jnp.asarray(last),
        cache_offset=jnp.asarray(off))
    _, tpages = tlayers.mla_apply_paged(
        tcfg, tm, torch.from_numpy(x), pages=tpages,
        block_tab=torch.from_numpy(bt), pos=torch.from_numpy(pos),
        last_idx=torch.from_numpy(last), cache_offset=torch.from_numpy(off))
    _leaves_close(tpages, jpages)
    for name, a in tpages.items():
        changed = sorted({int(p) for p in (a != before[name]).any(-1)
                          .nonzero()[:, 0]})
        # row 0 writes nothing: positions 2, 3 (page 3) are read-only,
        # 4..7 land on the unallocated entry, 8, 9 lie past the padded
        # tail and the table; row 1 writes positions 6, 7 into page 1
        # (its entry 1), and 8..13 lie past its table.
        assert changed == [1], (name, changed)


def test_latent_layout_matches_reference(model):
    jcfg, tcfg, _, _ = model
    for page in (8, 16):
        jl = jlayouts.get_layout(jcfg, page)
        tl = tlayouts.get_layout(tcfg, page)
        assert isinstance(tl, tlayouts.LatentLayout)
        assert [g.name for g in tl.groups] == [g.name for g in jl.groups] \
            == ["latent"]
        assert tl.prefix_shareable and jl.prefix_shareable
        assert tl.page_axis("latent") == jl.page_axis("latent") == 1
        assert tl.n_blocks("latent", 50) == jl.n_blocks("latent", 50)
        jd = jl.pool_decls({"latent": 11})
        td = tl.pool_decls({"latent": 11})
        for path, d in _flat(td):
            j = jd
            for k in path:
                j = j[k]
            assert d.shape == j.shape and d.axes == j.axes, path
            assert d.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        assert len(_flat(td)) == len(jax.tree.leaves(
            jd, is_leaf=lambda x: isinstance(x, jparams.Decl)))
    # MLA caches are bf16 whatever kv_cache_dtype says, as the reference's
    i8 = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    assert all(d.dtype == torch.bfloat16 for _, d in _flat(
        tregistry.paged_cache_decls(i8, 4, 8)))
    assert all(d.dtype == torch.bfloat16 for _, d in _flat(
        tregistry.cache_decls(i8, 2, 16)))
