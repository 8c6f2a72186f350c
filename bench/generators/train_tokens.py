"""Training batches: ``batch`` rows of ``seq + 1`` token ids per step,
uniform over the vocabulary, drawn on the device from the seed and the
step (inputs the first ``seq``, labels the last ``seq``).  Every row of
every step differs."""

from __future__ import annotations

import torch


def generate(params, seed: int, *, vocab: int, device, **_):
    b, s = int(params["batch"]), int(params["seq"])

    def batch(step: int):
        g = torch.Generator(device=device)
        g.manual_seed((int(seed) * 1_000_003 + step) % (2 ** 63))
        t = torch.randint(0, vocab, (b, s + 1), generator=g, device=device,
                          dtype=torch.int64)
        return {"tokens": t[:, :-1].to(torch.int32),
                "labels": t[:, 1:].to(torch.int32)}
    return batch
