"""repro_torch.train — the optimizer, gradient compression and the step
factories: ``make_train_step`` (microbatches, int8 with error feedback,
AdamW) and the serving steps (``make_prefill``, ``make_serve_step``)."""

from repro_torch.train.compress import compress_grads, decompress_grads, ef_init
from repro_torch.train.optim import TrainConfig, adamw_init, adamw_update, lr_schedule
from repro_torch.train.step import make_prefill, make_serve_step, make_train_step

__all__ = [
    "adamw_init", "adamw_update", "TrainConfig", "lr_schedule",
    "compress_grads", "decompress_grads", "ef_init",
    "make_train_step", "make_serve_step", "make_prefill",
]
