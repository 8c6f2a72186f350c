"""Deterministic synthetic data pipeline (port of ``train/data.py``).

Produces a reproducible token stream (a fixed-seed LCG over the logical
vocab with a lightweight Markov flavour so the loss actually decreases),
sharded per host: every host materializes only its slice of the global
batch (``host_slice``), which is what a real multi-pod input pipeline
does.  Labels are the next-token shift of the tokens — computed here so
the model/loss stay shift-free.

The pipeline is expressed as an F4 ``Stream`` producer (the port's
``core/stream``) so the training loop can overlap host data generation
with device compute (double-buffering = stream depth 2, the paper's
default ping-pong).  Everything here is numpy, drawn as the reference
draws it: both packages' batches are equal element for element.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig
from ..core.stream import Stream


@dataclasses.dataclass(frozen=True)
class DataCfg:
    global_batch: int
    seq_len: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1


def _tokens(cfg: ModelConfig, dcfg: DataCfg, step: int,
            extra_len: int = 1) -> np.ndarray:
    """Deterministic (step, host)-keyed token block, Markov-ish so a
    model can learn structure: t[i+1] = (a·t[i] + noise) mod V."""
    V = cfg.vocab_size
    b = dcfg.global_batch // dcfg.host_count
    s = dcfg.seq_len + extra_len
    rng = np.random.default_rng(
        np.random.SeedSequence([dcfg.seed, step, dcfg.host_index]))
    if cfg.family == "audio":
        shape = (b, s, cfg.n_codebooks)
    else:
        shape = (b, s)
    t = np.empty(shape, np.int64)
    t[:, 0] = rng.integers(0, V, shape[:1] + shape[2:])
    noise = rng.integers(0, 17, shape)
    for i in range(1, s):
        t[:, i] = (31 * t[:, i - 1] + 7 + noise[:, i]) % V
    return t.astype(np.int32)


def make_batch(cfg: ModelConfig, dcfg: DataCfg, step: int
               ) -> Dict[str, np.ndarray]:
    seq = dcfg.seq_len
    s_text = seq - cfg.vision_patches if cfg.family == "vlm" else seq
    d = DataCfg(dcfg.global_batch, s_text, dcfg.seed, dcfg.host_index,
                dcfg.host_count)
    t = _tokens(cfg, d, step)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    b = t.shape[0]
    rng = np.random.default_rng(
        np.random.SeedSequence([dcfg.seed + 1, step, dcfg.host_index]))
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.vision_patches, cfg.vision_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["cond"] = rng.standard_normal(
            (b, cfg.cond_len, cfg.d_model)).astype(np.float32)
    return batch


class DataPipeline:
    """Background producer feeding a bounded Stream (depth 2 = ping-pong
    double buffering).  ``it = pipeline.stream(); batch = it.Pop()``."""

    def __init__(self, cfg: ModelConfig, dcfg: DataCfg, depth: int = 2,
                 start_step: int = 0, num_steps: Optional[int] = None):
        self.cfg, self.dcfg = cfg, dcfg
        self.q: Stream = Stream(depth=depth, name="data-pipeline")
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(start_step, num_steps), daemon=True)
        self._thread.start()

    def _run(self, start: int, num: Optional[int]):
        step = start
        while not self._stop.is_set() and (num is None or step < start + num):
            try:
                self.q.Push(make_batch(self.cfg, self.dcfg, step),
                            timeout=0.2)
            except TimeoutError:
                continue
            step += 1

    def next(self) -> Dict[str, np.ndarray]:
        return self.q.Pop()

    def close(self):
        self._stop.set()
        self.q.close()
        self._thread.join(timeout=5)
