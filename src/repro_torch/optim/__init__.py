"""Optimizer of the port: the reference's AdamW and int8 gradient compression."""

from repro_torch.optim.adamw import AdamW, AdamWState  # noqa: F401
from repro_torch.optim.grad_compression import compress_grads_int8  # noqa: F401
