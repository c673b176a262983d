"""PyTorch + CUDA port of the TwinQuant serving path (the JAX package
``repro`` is the reference it is tested against).

Layout mirrors ``repro``: ``configs/``, ``core/``, ``kernels/``, ``models/``,
``launch/``; hand-written Hopper kernels live in ``csrc/`` and are built at
first use by :mod:`repro_torch.kernels.build`. Nothing here imports JAX or
the ``repro`` package.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and no card is
    present — the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type == "cuda" and dev.index is None:
        # tensors report an indexed device; name the same one
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
