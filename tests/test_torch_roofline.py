"""The port's roofline counter (``repro_torch.roofline``) held to the
contracts of the reference's HLO walker (``tests/test_roofline.py``):
exact matmul FLOPs, loops counted once per iteration, the fused byte
model, the roofline terms at one H100's constants, and the train step
against the analytic 6·N·D + attention estimate."""

import dataclasses

import pytest
import torch

from repro_torch.configs import get
from repro_torch.configs.base import ShapeCfg, smoke_variant
from repro_torch.launch import dryrun
from repro_torch.models import layers as L
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import count as C
from repro_torch.roofline import hw
from repro_torch.train import train_loop as TL

torch.set_num_threads(2)


def _count(fn, *shapes, dtype=torch.float32):
    fake = C.fake_mode()
    with fake:
        args = [torch.empty(s, dtype=dtype) for s in shapes]
        _, costs = C.count(fn, *args)
    return costs


def test_matmul_flops_exact():
    M, K, N = 128, 256, 64
    c = _count(lambda a, b: a @ b, (M, K), (K, N))
    assert c.flops == pytest.approx(2 * M * K * N, rel=1e-6)


def test_loop_counts_every_iteration():
    """An L-step loop of a matmul counts L times (the reference's walker
    multiplies a scan body by its trip count; eager loops run it L
    times)."""
    L_, M = 7, 64

    def f(a):
        for _ in range(L_):
            a = a @ a
        return a

    c = _count(f, (M, M))
    assert c.flops == pytest.approx(L_ * 2 * M ** 3, rel=1e-6)


def test_nested_loop_products():
    M, L1, L2 = 32, 3, 5

    def f(a):
        for _ in range(L1):
            y = a
            for _ in range(L2):
                y = y @ y
            a = y
        return a

    c = _count(f, (M, M))
    assert c.flops == pytest.approx(L1 * L2 * 2 * M ** 3, rel=1e-6)


def test_bytes_dominated_by_real_traffic():
    """A big matmul's bytes are ~(A + B + C), not polluted by the
    elementwise wrappers (the fused byte model)."""
    M = 512
    c = _count(lambda a, b: torch.tanh(a @ b) * 2.0 + 1.0, (M, M), (M, M))
    expect = 3 * M * M * 4
    assert expect <= c.bytes <= 4 * expect


def test_views_free_and_updates_move_their_update():
    """Views and reshapes are free; an in-place slice write moves twice
    its update, not the buffer (the reference's dynamic-update-slice)."""
    def f(cache, row):
        cache.view(64, 32, 16).transpose(0, 1)[:, 3].unsqueeze(0)
        cache[5] = row
        return cache

    c = _count(f, (64, 512), (512,))
    assert c.bytes == 2 * 512 * 4
    assert c.largest_alloc == 0


def test_roofline_terms_and_bottleneck():
    """The terms at the H100 constants: 989e12 FLOPs take 1 s, 3.35e12
    bytes 1 s, 900e9 bytes over one NVLink direction (450e9 B/s) 2 s."""
    r = RA.Roofline(
        arch="x", shape="train_4k", mesh="1",
        flops_per_device=989e12, bytes_per_device=3.35e12,
        collective_bytes_per_device=900e9,
        collectives={"total": int(900e9)},
        model_flops_global=989e12, n_active_params=1)
    assert hw.PEAK_BF16_FLOPS == 989e12 and hw.HBM_BW == 3.35e12
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(2.0)
    assert r.bottleneck == "collective" and r.t_bound == pytest.approx(2.0)
    assert r.mfu_bound(1) == pytest.approx(0.5)
    assert r.useful_flops_ratio(1) == pytest.approx(1.0)
    r.collective_bytes_per_device = 0.0
    r.bytes_per_device = 2 * 3.35e12
    assert r.bottleneck == "memory" and r.mfu_bound(1) == pytest.approx(0.5)
    d = r.to_dict(1)
    assert d["t_bound_s"] == pytest.approx(2.0) and d["n_chips"] == 1


def test_counter_matches_analytic_dense_flops():
    """Train-step FLOPs of a small dense LM land within 0.5-1.8x of the
    analytic 6·N·D + 12·b·s²·h·hd (the reference's bounds)."""
    cfg = dataclasses.replace(smoke_variant(get("minitron-4b")),
                              remat="none", vocab_size=512)
    b, s = 2, 64
    costs, _ = dryrun.lower_cell(cfg, ShapeCfg("t", "train", s, b),
                                 tcfg=TL.TrainCfg(compress_grads=False))
    d, ff, L_ = cfg.d_model, cfg.d_ff, cfg.n_layers
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    N_mat = L_ * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d
                  + 3 * d * ff) + d * cfg.padded_vocab
    analytic = 6 * N_mat * b * s + 12 * b * s * s * hq * hd * L_
    assert 0.5 * analytic <= costs.flops <= 1.8 * analytic, \
        (costs.flops, analytic)


@pytest.mark.parametrize("skip", [False, True])
def test_blocked_attention_by_formula(skip):
    """Under a counter the blocked attention returns zeros of the right
    shape and records its visited tiles' products: forward QKᵀ + PV per
    tile, backward 4 score-sized + 3 PV-sized products."""
    b, hq, hkv, s, d = 1, 4, 2, 256, 32
    tiles, _, _ = C.blocked_tiles(s, s, True, None, 64, 64, skip)
    assert tiles == (10 if skip else 16)
    fake = C.fake_mode()
    with fake:
        q = torch.empty(b, hq, s, d, requires_grad=True)
        k = torch.empty(b, hkv, s, d, requires_grad=True)
        v = torch.empty(b, hkv, s, d, requires_grad=True)
        with C.Counter() as c:
            out = L.attention_blocked(q, k, v, block_q=64, block_k=64,
                                      block_skip=skip)
            fwd = c.costs.flops
            out.sum().backward()
    tile = 2 * b * hq * 64 * 64 * d
    assert out.shape == (b, hq, s, d)
    assert fwd == 2 * tile * tiles
    assert c.costs.flops - fwd == 7 * tile * tiles


def test_decode_kernels_by_formula_count_live_keys():
    """B3's wrapper records its work from the positions on real tensors
    (live keys only) and from the whole cache on fake ones, and runs its
    twin uncounted."""
    from repro_torch.kernels.flash_attention import flash_attention_decode
    b, hq, hkv, S, d = 2, 4, 2, 64, 16
    q, k, v = (torch.randn(b, hq, 1, d), torch.randn(b, hkv, S, d),
               torch.randn(b, hkv, S, d))
    pos = torch.tensor([9, 40], dtype=torch.int32)
    with C.Counter() as c:
        out = flash_attention_decode(q, k, v, pos)
    keys = 10 + 41
    assert c.costs.flops == 2 * hq * keys * 2 * d
    assert set(c.costs.ops) == {"flash_attention_decode"}
    torch.testing.assert_close(out, flash_attention_decode(q, k, v, pos))
    fake = C.fake_mode()
    with fake:
        fq, fk, fv = (fake.from_tensor(t) for t in (q, k, v))
        fpos = fake.from_tensor(pos)
        with C.Counter() as c:
            flash_attention_decode(fq, fk, fv, fpos)
    assert c.costs.flops == 2 * hq * b * S * 2 * d
