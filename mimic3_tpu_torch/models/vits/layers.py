"""Primitive layers for the VITS stack (PyTorch layout, functional).

Counterpart of ``mimic3_tpu/models/vits/layers.py``.  Conventions:

- activations: ``[B, C, T]``,
- masks: ``[B, 1, T]`` float (1.0 = valid),
- conv weights: ``[Cout, Cin/groups, K]`` (torch ``Conv1d``),
- transposed-conv weights: ``[Cin, Cout, K]`` (torch ``ConvTranspose1d``),
- parameters live in nested dicts keyed by torch-style module names.
  Synthesis weights arrive with weight norm folded (``runtime/convert.py``);
  training weights keep the ``weight_v``/``weight_g`` pair, resolved at
  every call by :func:`conv_weight` so the gradient reaches ``v`` and
  ``g``.
- on a tensor-parallel mesh a conv's leaves may be split over the tp
  row's devices (``parallel/tensor.py::Split``): :func:`conv1d` and
  :func:`conv_transpose1d` route such a layer to ``parallel/tensor.py``
  and return the whole output, so their callers run unchanged; any other
  function given a split leaf raises.
"""

from __future__ import annotations

import typing

import torch
import torch.nn.functional as F

from ...parallel import tensor as tp

Params = typing.Dict[str, typing.Any]

LRELU_SLOPE = 0.1


def conv_weight(
    p: Params, out_dim: int = 0
) -> typing.Union[torch.Tensor, tp.Split]:
    """Resolve a conv's weight, folding weight norm when present.

    weight-norm: ``w = g * v / ||v||`` with the norm over every axis but
    the output channel ``out_dim``: dim 0 of a conv's ``[Cout, Cin, K]``
    (and of a 2-D conv's ``[Cout, Cin, kh, kw]``), dim 1 of a transposed
    conv's ``[Cin, Cout, K]``.  ``g`` is ``[Cout, 1, 1]`` (``[1, Cout,
    1]`` transposed), broadcast against ``v``.  A pair split over a tp
    row on the output channel folds part by part (each output channel's
    norm lies in its part): a :class:`~...parallel.tensor.Split` of the
    folded parts.
    """
    if "weight" in p:
        return p["weight"]
    v, g = p["weight_v"], p["weight_g"]
    if isinstance(v, tp.Split):
        if v.axis != out_dim or not isinstance(g, tp.Split):
            raise ValueError(
                "a weight-norm pair splits over a tp row only on its "
                "output channel, v and g together"
            )
        return tp.Split(tuple(_fold(gj, vj, out_dim)
                              for gj, vj in zip(g.parts, v.parts)),
                        v.axis, v.row)
    return _fold(g, v, out_dim)


def _fold(g: torch.Tensor, v: torch.Tensor, out_dim: int) -> torch.Tensor:
    dims = tuple(d for d in range(v.dim()) if d != out_dim)
    norm = v.square().sum(dim=dims, keepdim=True).sqrt()
    return g * v / norm


def conv1d(
    x: torch.Tensor,
    p: Params,
    *,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    groups: int = 1,
    dtype: typing.Optional[torch.dtype] = None,
) -> torch.Tensor:
    """1-D convolution (torch ``Conv1d`` semantics), computed in x's dtype."""
    if dtype is not None:
        x = x.to(dtype)
    if tp.is_split(p):
        return tp.conv(x, conv_weight(p), p.get("bias"), stride=stride,
                       padding=padding, dilation=dilation, groups=groups)
    bias = p.get("bias")
    return F.conv1d(
        x,
        conv_weight(p).to(x.dtype),
        None if bias is None else bias.to(x.dtype),
        stride=stride,
        padding=padding,
        dilation=dilation,
        groups=groups,
    )


def conv_transpose1d(
    x: torch.Tensor,
    p: Params,
    *,
    stride: int,
    padding: int = 0,
    dtype: typing.Optional[torch.dtype] = None,
) -> torch.Tensor:
    """1-D transposed convolution; output length
    ``(T-1)*stride - 2*padding + K``."""
    if dtype is not None:
        x = x.to(dtype)
    if tp.is_split(p):
        return tp.conv(x, conv_weight(p, out_dim=1), p.get("bias"),
                       transpose=True, stride=stride, padding=padding)
    bias = p.get("bias")
    return F.conv_transpose1d(
        x,
        conv_weight(p, out_dim=1).to(x.dtype),
        None if bias is None else bias.to(x.dtype),
        stride=stride,
        padding=padding,
    )


def layer_norm(
    x: torch.Tensor, p: Params, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the channel axis (dim 1), computed in float32."""
    y = F.layer_norm(
        x.float().transpose(1, 2),
        (x.shape[1],),
        p["gamma"].float(),
        p["beta"].float(),
        eps,
    )
    return y.transpose(1, 2).to(x.dtype)


def embedding(ids: torch.Tensor, p: Params) -> torch.Tensor:
    """Token embedding lookup: ids ``[B, T]`` -> ``[B, T, C]``."""
    return F.embedding(ids.long(), p["weight"])


def leaky_relu(
    x: torch.Tensor, slope: float = LRELU_SLOPE
) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def fused_add_tanh_sigmoid_multiply(
    x: torch.Tensor, g: torch.Tensor, channels: int
) -> torch.Tensor:
    """WaveNet gate: ``tanh(a) * sigmoid(b)`` over the summed halves."""
    summed = x + g
    return torch.tanh(summed[:, :channels]) * torch.sigmoid(
        summed[:, channels:]
    )


def sequence_mask(
    lengths: torch.Tensor, max_length: int
) -> torch.Tensor:
    """``[B, 1, T]`` float mask from lengths."""
    pos = torch.arange(max_length, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).float()[:, None, :]
