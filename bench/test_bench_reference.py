"""The plain reference held to the program at smoke width on the CPU,
in float32: the logits of a whole sequence, the program's train-mode
forward against the reference's, on the same weights (the harness's
draw), with the MLP gated and ungated."""

import dataclasses

import pytest
import torch

from bench import harness, weights
from bench.reference.model import Reference


def smoke(**kw):
    from repro_torch import configs
    from repro_torch.configs.base import smoke_variant
    return dataclasses.replace(smoke_variant(configs.get("minitron-4b")),
                               **kw)


@pytest.mark.parametrize("gated", [False, True])
def test_reference_matches_the_program(gated):
    from repro_torch.models import registry
    cfg = smoke(mlp_gated=gated)
    w = weights.draw(cfg, 2 ** 31 + 3, "cpu", dtype=torch.float32)
    ids = torch.randint(0, cfg.vocab_size, (1, 40),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = registry.forward(cfg, w, {"tokens": ids}, mode="train")[0]
        ref = Reference(harness.file_view(cfg), w, torch.device("cpu"))
        hid = ref.hidden(ids[0])
        want = torch.cat([lg for _, lg in ref.logits_at(
            hid, torch.arange(40))])
    err = (got - want).abs().max() / want.abs().max()
    assert err < 2e-5, float(err)


def test_control_is_coarser_than_the_program():
    """At smoke width the fp8 control's logits lie far further from the
    float32 reference than a bf16 run of the program's own forward."""
    from repro_torch.models import registry
    cfg = smoke(mlp_gated=False, dtype="bfloat16")
    w = weights.draw(cfg, 11, "cpu", dtype=torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (1, 48),
                        generator=torch.Generator().manual_seed(2))
    f = harness.file_view(cfg)
    rows = torch.arange(48)
    with torch.no_grad():
        prog = registry.forward(cfg, w, {"tokens": ids},
                                mode="train")[0].float()
        ref = Reference(f, w, torch.device("cpu"))
        want = torch.cat([lg for _, lg in ref.logits_at(ref.hidden(ids[0]),
                                                        rows)])
        ctl = Reference(f, w, torch.device("cpu"), lowp="fp8")
        low = torch.cat([lg for _, lg in ctl.logits_at(ctl.hidden(ids[0]),
                                                       rows)])
    e_prog = (prog - want).abs().max()
    e_ctl = (low - want).abs().max()
    assert e_ctl > 3 * e_prog, (float(e_prog), float(e_ctl))
