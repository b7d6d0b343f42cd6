"""Device resolution shared by the port's entry points.

Every entry point (``build_engine``, ``SearchEngine``, ``fit_mpad``,
``build_ivfpq``) runs on the CUDA device unless the caller names another
one. With no CUDA device and no explicit ``device`` they raise: the port
never falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

# the device types whose tensors take a kernel's card route: a CUDA tensor
# launches the kernel; a meta tensor (no data: the dry-run's model of the
# card, ``launch.dryrun``) takes the launch's meta kernel, which gives the
# output's shape and counts as a launch
CARD_DEVICE_TYPES = ("cuda", "meta")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which must
    be present (pass ``device="cpu"`` to run on the CPU on purpose)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU explicitly")
    return torch.device("cuda")


def cpu_generator(seed: int) -> torch.Generator:
    """A seeded CPU generator. Draws are made on the CPU and then moved, so
    a seed gives the same numbers whatever device the engine runs on."""
    return torch.Generator().manual_seed(int(seed))
