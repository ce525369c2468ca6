"""Seeded weights, made on the device in one draw: kernels N(0, 1/fan_in)
(the head's times the mix's ``head_gain``, which makes the posteriors as
peaky as a trained model's), recurrent biases N(0, 0.01), BatchNorm scale
1, bias 0 and statistics 0 and 1. Keyed by the names of the model's
state dict: the same tensors go to the program and to the reference."""

from __future__ import annotations

import numpy as np


def fan_in(shape) -> int:
    """A conv kernel (out, in, kT, kF) reads in * kT * kF inputs; a
    matrix (..., in, out) reads ``in``."""
    return int(np.prod(shape[1:])) if len(shape) == 4 else int(shape[-2])


def make_weights(shapes: dict, seed: int, device, head_gain: float = 1.0) -> dict:
    """{name: float32 tensor on ``device``} for {name: shape}."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    drawn = [n for n, s in shapes.items() if n.endswith(("kernel", "weight", "_bias"))]
    sizes = [int(np.prod(shapes[n])) for n in drawn]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for name, part in zip(drawn, flat.split(sizes)):
        shape = shapes[name]
        if name.endswith("_bias"):
            scale = 0.1
        else:
            scale = 1.0 / np.sqrt(fan_in(shape))
            if name == "head_kernel":
                scale *= head_gain
        out[name] = part.view(shape) * scale
    for name, shape in shapes.items():
        if name not in out:
            fill = 1.0 if name.endswith(("scale", "var")) else 0.0
            out[name] = torch.full(shape, fill, device=device, dtype=torch.float32)
    return out
