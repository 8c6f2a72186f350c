"""The frozen formulas of ``bench.counts`` tied to the program's own
counts at smoke width on the CPU: the forward's model FLOPs against
``roofline/count.Counter`` (the dry-run's tolerance, 10%), the train
step's 3x the forward, and B1's bound against ``chip_smoke.bound_ms``
on the same cases."""

import dataclasses

import pytest
import torch

from bench import counts, harness


def smoke(arch, **kw):
    from repro_torch import configs
    from repro_torch.configs.base import smoke_variant
    return dataclasses.replace(smoke_variant(configs.get(arch)), **kw)


@pytest.mark.parametrize("gated", [False, True])
def test_forward_flops_match_the_counter(gated):
    from repro_torch.models import registry
    from repro_torch.roofline import count as C
    cfg = smoke("minitron-4b", mlp_gated=gated)
    b, s = 2, 32
    params = registry.init(cfg, 0, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (b, s))
    with torch.no_grad(), C.Counter(scopes=False) as c:
        registry.forward(cfg, params, {"tokens": tok}, mode="train")
    f = harness.file_view(cfg)
    f["vocab_size"] = cfg.padded_vocab
    computed = counts.active_weights(f)
    # the counter counts the blocked attention by whole tiles (here one
    # tile of s x s), so hold the formula at those pairs
    want = (2.0 * computed * b * s + counts.attention_flops(f, b * s * s)
            + 2.0 * f["hidden_size"] * f["vocab_size"] * b * s)
    assert c.costs.flops == pytest.approx(want, rel=0.10)
    # and the model FLOPs the metrics use count only the causal pairs
    model = counts.forward_flops(f, b * s, b * counts.causal_pairs(0, s),
                                 b * s)
    assert model <= want


def test_train_step_is_three_forwards():
    f = harness.file_view(smoke("minitron-4b"))
    assert counts.train_step_flops(f, 2, 64) == pytest.approx(
        3 * counts.forward_flops(f, 128, 2 * counts.causal_pairs(0, 64), 128))


def test_decode_and_chunk_pairs():
    assert counts.causal_pairs(0, 4) == 10
    assert counts.causal_pairs(10, 2) == 10 * 2 + 3
    f = harness.file_view(smoke("minitron-4b"))
    assert counts.decode_step_flops(f, [5, 9]) == pytest.approx(
        counts.forward_flops(f, 2, 6 + 10, 2))


@pytest.mark.parametrize("slots,live_pos", [(8, [0, 15, 16, 100]),
                                            (4, [1023, 7, 300, 64])])
def test_b1_bound_matches_chip_smoke(slots, live_pos, monkeypatch):
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    c = {"num_hidden_layers": 1, "num_attention_heads": 24,
         "num_key_value_heads": 8, "head_dim": 128}
    page, nb = 16, 64
    pos = torch.zeros(slots, dtype=torch.int32)
    pos[:len(live_pos)] = torch.tensor(live_pos)
    # rows past the live ones read no page: the invalid table row
    tab = torch.arange(slots * nb, dtype=torch.int32).view(slots, nb)
    case = {"q": torch.zeros(slots, 24, 1, 128, dtype=torch.bfloat16),
            "k_pages": torch.zeros(1, 8, page, 128, dtype=torch.bfloat16),
            "block_tab": tab, "pos": pos, "page_base": None,
            "window": None, "k_scale_pages": None}
    want_ms, _ = chip_smoke.bound_ms(case, "NVIDIA H100 80GB HBM3")
    # chip_smoke counts a page for every row; the benchmark's positions
    # are the live slots', every row of the call counted for q and tables
    full = [int(p) for p in pos]
    got = counts.b1_step_bound_s(c, full, page, slots, nb)
    assert got * 1e3 == pytest.approx(want_ms, rel=1e-9)
