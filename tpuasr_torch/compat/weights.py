"""``tpuasr`` (flax) variable trees <-> the port's ``DeepSpeech2``.

A ``.tpuasr`` checkpoint holds ``{"params": ..., "batch_stats": ...}``
as nested dicts of numpy arrays with the flax module names
(``conv{i}/Conv_0/kernel``, ``rnn{i}/bi/recurrent_kernel``,
``head_bn``, ``head/kernel``, ...). ``from_jax_variables`` turns such a
tree into a state dict of ``tpuasr_torch.model.ds2.DeepSpeech2``, so a
checkpoint trained by the JAX package serves and trains unchanged (GRU,
LSTM and vanilla RNN alike: a bidirectional layer keeps its recurrent
weights under ``rnn{i}/bi``, (2, H_in, G*H) and (2, H, G*H) with G = 3,
4 or 1, whatever the rnn_impl; a unidirectional one under
``rnn{i}/fwd``, ``input_proj/{kernel,bias}`` (H_in, G*H) and
``recurrent_{kernel,bias}`` (H, G*H), followed by
``lookahead/Conv_0/kernel`` (ctx, 1, H) when ``lookahead_context`` > 0);
``to_jax_variables`` is its inverse. ``init_variables`` builds a seeded
tree of the same shape without JAX (random statistics, for serving
tests); ``init_train_variables`` draws a fresh model from flax's init
distributions. ``momentum_to_opt_state`` and ``load_momentum`` map the
optimizer's Nesterov momentum buffers to and from optax's state dict
``{"0": {}, "1": {"trace": <params tree>}}`` (clip, then trace).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuasr_torch.model.ds2 import (
    CONV_SPECS,
    GATES,
    DeepSpeech2,
    ModelConfig,
    conv_out_features,
)

_BI_KEYS = ("input_kernel", "input_bias", "recurrent_kernel", "recurrent_bias")
_FWD_KEYS = (("input_proj.kernel", ("input_proj", "kernel")),
             ("input_proj.bias", ("input_proj", "bias")),
             ("recurrent_kernel", ("recurrent_kernel",)),
             ("recurrent_bias", ("recurrent_bias",)))


def has_lookahead(cfg: ModelConfig) -> bool:
    return not cfg.bidirectional and cfg.lookahead_context > 0


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def variable_paths(cfg: ModelConfig):
    """(state-dict name, flax path, is_conv) of every parameter and
    BatchNorm statistic of ``DeepSpeech2(cfg)``; the path starts with
    "params" or "batch_stats". Conv kernels are flax's (kT, kF, in, out)
    and PyTorch's (out, in, kT, kF); every other array keeps its layout."""
    out = []

    def bn(prefix, path):
        for k in ("scale", "bias"):
            out.append((prefix + k, ("params", *path, k), False))
        for k in ("mean", "var"):
            out.append((prefix + k, ("batch_stats", *path, k), False))

    for i in range(len(CONV_SPECS)):
        out.append((f"convs.{i}.weight", ("params", f"conv{i}", "Conv_0", "kernel"), True))
        bn(f"convs.{i}.bn.", (f"conv{i}", "MaskedBatchNorm_0"))
    for i in range(cfg.hidden_layers):
        if i > 0:
            bn(f"rnns.{i}.bn.", (f"rnn{i}", "MaskedBatchNorm_0"))
        if cfg.bidirectional:
            for k in _BI_KEYS:
                out.append((f"rnns.{i}.bi.{k}", ("params", f"rnn{i}", "bi", k), False))
        else:
            for name, path in _FWD_KEYS:
                out.append((f"rnns.{i}.fwd.{name}", ("params", f"rnn{i}", "fwd", *path),
                            False))
    if has_lookahead(cfg):
        out.append(("lookahead.kernel", ("params", "lookahead", "Conv_0", "kernel"), False))
    bn("head_bn.", ("head_bn",))
    out.append(("head_kernel", ("params", "head", "kernel"), False))
    return out


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _to_torch(a, is_conv: bool) -> torch.Tensor:
    t = _t(a)
    return t.permute(3, 2, 0, 1).contiguous() if is_conv else t


def _to_numpy(t: torch.Tensor, is_conv: bool) -> np.ndarray:
    """A copy: the model updates its parameters and statistics in place."""
    t = t.detach().to("cpu", torch.float32)
    if is_conv:
        t = t.permute(2, 3, 1, 0)
    return np.array(t.numpy(), order="C", copy=True)


def from_jax_variables(variables: dict, cfg: ModelConfig) -> dict:
    """flax ``{"params", "batch_stats"}`` tree (numpy leaves) -> state
    dict of ``DeepSpeech2(cfg)``."""
    return {name: _to_torch(_get(variables, path), conv)
            for name, path, conv in variable_paths(cfg)}


def to_jax_variables(model: DeepSpeech2, state: dict | None = None) -> dict:
    """``DeepSpeech2`` -> flax ``{"params", "batch_stats"}`` tree of f32
    numpy arrays, the inverse of ``from_jax_variables``. ``state``
    overrides entries of the model's state dict (a tensor-parallel
    model's sharded leaves made whole, ``train.mesh.whole_tensors``)."""
    sd = {**model.state_dict(), **(state or {})}
    tree: dict = {"params": {}, "batch_stats": {}}
    for name, path, conv in variable_paths(model.config):
        _set(tree, path, _to_numpy(sd[name], conv))
    return tree


def momentum_buffers(model: DeepSpeech2, optimizer: torch.optim.Optimizer) -> dict:
    """{parameter name: its SGD momentum buffer}, zeros for a parameter
    with no buffer yet (no step taken), as optax initialises its trace."""
    out = {}
    for name, p in model.named_parameters():
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        out[name] = torch.zeros_like(p) if buf is None else buf
    return out


def momentum_to_opt_state(model: DeepSpeech2, optimizer: torch.optim.Optimizer,
                          buffers: dict | None = None) -> dict:
    """The SGD momentum buffers as optax's state dict of
    ``chain(clip_by_global_norm, trace(nesterov))``: ``{"0": {}, "1":
    {"trace": <params tree>}}``. ``buffers`` ({name: tensor}) stands in
    for ``momentum_buffers(model, optimizer)`` (a tensor-parallel
    model's buffers made whole)."""
    buffers = buffers if buffers is not None else momentum_buffers(model, optimizer)
    trace: dict = {}
    for name, path, conv in variable_paths(model.config):
        if path[0] != "params":
            continue
        _set(trace, path[1:], _to_numpy(buffers[name], conv))
    return {"0": {}, "1": {"trace": trace}}


def load_momentum(model: DeepSpeech2, optimizer: torch.optim.Optimizer,
                  opt_state: dict, local=None) -> None:
    """Set the SGD momentum buffers from optax's state dict (the inverse
    of ``momentum_to_opt_state``). torch's first Nesterov step stores
    the gradient as its buffer, which equals optax's trace update from
    a zero trace, so a zero trace loads as a zero buffer. ``local(name,
    whole)`` cuts a whole buffer to the parameter's shard (a
    tensor-parallel model)."""
    trace = opt_state["1"]["trace"]
    params = dict(model.named_parameters())
    for name, path, conv in variable_paths(model.config):
        if path[0] != "params":
            continue
        p = params[name]
        buf = _to_torch(_get(trace, path[1:]), conv)
        if local is not None:
            buf = local(name, buf)
        optimizer.state[p]["momentum_buffer"] = buf.to(p.device, p.dtype)


def model_from_variables(variables: dict, cfg: ModelConfig,
                         device: torch.device, trainable: bool = False) -> DeepSpeech2:
    """A ``DeepSpeech2`` on ``device`` holding a flax tree's weights
    (strict: every parameter and statistic must be present); frozen
    unless ``trainable``."""
    model = DeepSpeech2(cfg)
    model.load_state_dict(from_jax_variables(variables, cfg), strict=True)
    model = model.to(device)
    return model.train() if trainable else model.eval().requires_grad_(False)


def init_variables(cfg: ModelConfig, seed: int = 0) -> dict:
    """A seeded flax-shaped ``{"params", "batch_stats"}`` tree of float32
    numpy arrays (LeCun-normal kernels, small random biases and BN
    statistics), made without JAX."""
    rng = np.random.RandomState(seed)
    g = GATES[cfg.rnn_type] * cfg.hidden_size

    def normal(shape, fan_in, scale=1.0):
        return (rng.standard_normal(shape) * scale / np.sqrt(fan_in)).astype(np.float32)

    def bn(c):
        return ({"scale": (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                 "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)},
                {"mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, c).astype(np.float32)})

    params: dict = {}
    stats: dict = {}
    c_in = 1
    for i, (kt, kf, *_rest) in enumerate(CONV_SPECS):
        c = cfg.conv_channels
        bp, bs = bn(c)
        params[f"conv{i}"] = {
            "Conv_0": {"kernel": normal((kt, kf, c_in, c), kt * kf * c_in)},
            "MaskedBatchNorm_0": bp,
        }
        stats[f"conv{i}"] = {"MaskedBatchNorm_0": bs}
        c_in = c
    h_in = conv_out_features(cfg.n_features, cfg.conv_channels)
    for i in range(cfg.hidden_layers):
        layer: dict = {}
        if i > 0:
            bp, bs = bn(h_in)
            layer["MaskedBatchNorm_0"] = bp
            stats[f"rnn{i}"] = {"MaskedBatchNorm_0": bs}
        if cfg.bidirectional:
            layer["bi"] = {
                "input_kernel": normal((2, h_in, g), h_in),
                "input_bias": (0.1 * rng.standard_normal((2, g))).astype(np.float32),
                "recurrent_kernel": normal((2, cfg.hidden_size, g), cfg.hidden_size),
                "recurrent_bias": (0.1 * rng.standard_normal((2, g))).astype(np.float32),
            }
        else:
            layer["fwd"] = {
                "input_proj": {
                    "kernel": normal((h_in, g), h_in),
                    "bias": (0.1 * rng.standard_normal(g)).astype(np.float32)},
                "recurrent_kernel": normal((cfg.hidden_size, g), cfg.hidden_size),
                "recurrent_bias": (0.1 * rng.standard_normal(g)).astype(np.float32),
            }
        params[f"rnn{i}"] = layer
        h_in = cfg.hidden_size
    if has_lookahead(cfg):
        params["lookahead"] = {"Conv_0": {"kernel": normal(
            (cfg.lookahead_context, 1, cfg.hidden_size), cfg.lookahead_context)}}
    bp, bs = bn(cfg.hidden_size)
    params["head_bn"], stats["head_bn"] = bp, bs
    params["head"] = {"kernel": normal((cfg.hidden_size, cfg.n_classes),
                                       cfg.hidden_size)}
    return {"params": params, "batch_stats": stats}


def _truncated_normal(rng, shape, std):
    """flax's truncated normal: N(0, 1) cut at +-2, scaled to ``std``."""
    out = rng.standard_normal(shape)
    bad = np.abs(out) > 2.0
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > 2.0
    return out * std


def _lecun_normal(rng, shape):
    """flax ``lecun_normal``: variance 1/fan_in, truncated normal; fan_in
    is shape[-2] times the product of the leading axes (flax's
    receptive field)."""
    fan_in = shape[-2] * int(np.prod(shape[:-2]))
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978  # stddev of N(0,1) cut at 2
    return _truncated_normal(rng, shape, std).astype(np.float32)


def _orthogonal(rng, shape):
    """flax ``orthogonal``: the axes before the last flattened into rows,
    a QR of a normal matrix with R's diagonal signs folded in."""
    n_cols = shape[-1]
    n_rows = int(np.prod(shape)) // n_cols
    a = rng.standard_normal((max(n_rows, n_cols), min(n_rows, n_cols)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))[None, :]
    if n_rows < n_cols:
        q = q.T
    return q.reshape(shape).astype(np.float32)


def init_train_variables(cfg: ModelConfig, seed: int = 0) -> dict:
    """A fresh model's flax-shaped ``{"params", "batch_stats"}`` tree,
    drawn from the distributions ``tpuasr``'s flax modules initialise
    with: orthogonal recurrent kernels (LeCun-normal for the vanilla
    RNN), LeCun-normal input, conv, Lookahead and head kernels, zero
    biases, BatchNorm scale 1 and bias 0, statistics 0 and 1. Seeded
    numpy, so the values are not flax's own."""
    rng = np.random.RandomState(seed)
    g = GATES[cfg.rnn_type] * cfg.hidden_size
    params: dict = {}
    stats: dict = {}

    def bn(c):
        return ({"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)},
                {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)})

    c_in = 1
    for i, (kt, kf, *_rest) in enumerate(CONV_SPECS):
        c = cfg.conv_channels
        bp, bs = bn(c)
        params[f"conv{i}"] = {"Conv_0": {"kernel": _lecun_normal(rng, (kt, kf, c_in, c))},
                              "MaskedBatchNorm_0": bp}
        stats[f"conv{i}"] = {"MaskedBatchNorm_0": bs}
        c_in = c
    h_in = conv_out_features(cfg.n_features, cfg.conv_channels)
    for i in range(cfg.hidden_layers):
        layer: dict = {}
        if i > 0:
            layer["MaskedBatchNorm_0"], bs = bn(h_in)
            stats[f"rnn{i}"] = {"MaskedBatchNorm_0": bs}
        # the vanilla RNN's recurrent kernel is LeCun-normal, the others'
        # orthogonal (tpuasr/model/ds2.py:267, 409)
        rec = _lecun_normal if cfg.rnn_type == "rnn" else _orthogonal
        if cfg.bidirectional:
            layer["bi"] = {
                "input_kernel": _lecun_normal(rng, (2, h_in, g)),
                "input_bias": np.zeros((2, g), np.float32),
                "recurrent_kernel": rec(rng, (2, cfg.hidden_size, g)),
                "recurrent_bias": np.zeros((2, g), np.float32),
            }
        else:
            layer["fwd"] = {
                "input_proj": {"kernel": _lecun_normal(rng, (h_in, g)),
                               "bias": np.zeros(g, np.float32)},
                "recurrent_kernel": rec(rng, (cfg.hidden_size, g)),
                "recurrent_bias": np.zeros(g, np.float32),
            }
        params[f"rnn{i}"] = layer
        h_in = cfg.hidden_size
    if has_lookahead(cfg):
        params["lookahead"] = {"Conv_0": {"kernel": _lecun_normal(
            rng, (cfg.lookahead_context, 1, cfg.hidden_size))}}
    params["head_bn"], stats["head_bn"] = bn(cfg.hidden_size)
    params["head"] = {"kernel": _lecun_normal(rng, (cfg.hidden_size, cfg.n_classes))}
    return {"params": params, "batch_stats": stats}
