"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU. Raises when CUDA is asked for and absent — the port
    never carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type not in DEVICES:
        raise ValueError(f"unsupported device {device!r}; use one of {DEVICES}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU"
            )
        # the frontend DFT needs full f32 products (the JAX package runs
        # it at Precision.HIGHEST); bf16 GEMMs reduce in f32 like XLA's
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


def to_device(array, device: torch.device) -> torch.Tensor:
    """A host array (or CPU tensor) on ``device``. On a card the copy is
    asynchronous from pinned memory: the host queues it and goes on,
    where a blocking copy would wait for everything queued before it."""
    t = torch.as_tensor(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
