"""Training (port of ``train/``): AdamW, the train step, the synthetic
data pipeline, atomic checkpoints and the restart supervisor."""

from . import checkpoint, data, fault, optimizer, train_loop
