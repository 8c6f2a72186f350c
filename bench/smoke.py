"""A cell at smoke width for runs on the CPU: the configuration cut by
the port's ``smoke_variant`` and the traffic shrunk to a few slots of
short requests.  The CPU tests and a rehearsal before a chip run use
it; the benchmark's own runs never do."""

from __future__ import annotations

import dataclasses

from . import harness


def smoke_cell(name: str, root=harness.ROOT, dtype: str = "bfloat16"):
    """(cell, cfg) of the serving cell ``name`` at smoke width."""
    from repro_torch.configs.base import smoke_variant
    cell = harness.resolve(name, root)
    full = harness.port_config(cell.config)
    cfg = dataclasses.replace(smoke_variant(full), dtype=dtype)
    cell.config = harness.file_view(cfg)
    cell.serving.update(n_slots=4, max_seq=96, page_size=8,
                        prefill_chunk=16, n_pages=None)
    cell.traffic["params"] = {"prompt_len": [8, 24], "output_len": [16, 40],
                              "n_backlog": 12}
    return cell, cfg
