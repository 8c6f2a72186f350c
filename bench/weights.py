"""Random weights from the seed, drawn on the device in a few large
calls and in the type they are served in.

The tree's structure (names, shapes, which leaves start at zero, the
per-leaf scale) is the port's parameter declaration; the values are the
harness's: one normal draw over a flat buffer from one generator, each
leaf a view of it scaled by its declared std (else 1/sqrt(fan_in)).
Both the program and the reference are handed this same tree."""

from __future__ import annotations

import math

import torch


def draw(cfg, seed: int, device, dtype=torch.bfloat16):
    from repro_torch.models import registry
    from repro_torch.models.params import tree_map
    decls = registry.decls(cfg)
    leaves = []
    tree_map(lambda path, d: leaves.append((path, d)), decls)
    normal = [(p, d) for p, d in leaves if d.init == "normal"]
    total = sum(math.prod(d.shape) for _, d in normal)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=g, dtype=dtype, device=device)
    views, off = {}, 0
    for path, d in normal:
        n = math.prod(d.shape)
        std = d.std if d.std is not None else 1.0 / math.sqrt(
            d.shape[-2] if len(d.shape) >= 2 else d.shape[-1])
        views[path] = flat[off:off + n].view(d.shape).mul_(std)
        off += n

    def leaf(path, d):
        if d.init == "normal":
            return views[path]
        fill = torch.zeros if d.init == "zeros" else torch.ones
        return fill(d.shape, dtype=dtype if d.dtype.is_floating_point
                    else d.dtype, device=device)
    return tree_map(leaf, decls)

