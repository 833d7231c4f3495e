"""The voice-file parameter layout, and its reading into torch layout.

``generator.npz`` holds one array per dotted module path, the layout of
Mimic 3 voices converted from ONNX: convolution weights ``[K, Cin/groups,
Cout]`` (transposed convolutions ``[K, Cin, Cout]``), weight norm as
``weight_v`` with ``weight_g`` ``[1, 1, Cout]``, layer norms as
``gamma``/``beta``.  Leaves that only training reads (the duration
predictor's posterior, its first coupling) are absent, as in converted
voices.

:func:`layout` lists every leaf with its shape and the initializer of
the published code (PyTorch's defaults, VITS ``init_weights``), with
three departures, each because the published initializer hides the
layers before it from any comparison of outputs:

- the coupling flow's ``post`` convs, zero in VITS, take the default
  initializer (a zero ``post`` makes the flow the identity);
- the duration predictor's ConvFlow ``proj`` convs, zero in VITS, a
  normal of std 0.001: durations then depend on the text, by about 1%
  at noise 0, so a fault in the predictor's conditioning moves frame
  counts, while their spread over weight seeds stays near 0.4% (std
  0.01 gave 7%, and the seed changed the work);
- the decoder's upsamplers, a normal of std 0.01 in VITS, a normal that
  keeps the signal's scale through the leaky ReLU (He's gain over the
  ``Cin * K / stride`` products of each output).  At std 0.01 each
  upsampler shrinks the signal about threefold while the biases stay,
  and the HiFi-GAN waveform is 99.6% the biases' pattern: two texts
  give waveforms 0.27% apart (measured on the CPU at full width).
"""

from __future__ import annotations

import math
import typing
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

SDP_FILTER = 192  # StochasticDurationPredictor(hidden, 192, 3, 0.5, 4)
SDP_BINS = 10
SDP_DDS_LAYERS = 3
SDP_KERNEL = 3
SDP_CONV_FLOWS = (3, 5, 7)  # flows.1 is dropped at inference
FLOW_COUPLINGS = 4
WN_LAYERS = 4
WN_KERNEL = 5
REL_WINDOW = 4


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: typing.Tuple[int, ...]
    init: str  # "uniform", "normal", "zeros", "ones" or "norm_of"
    scale: float = 0.0  # uniform bound or normal std
    of: str = ""  # for "norm_of": the weight_v whose norm this is


def _conv(leaves, name, cin, cout, k, *, groups=1, bias=True, wn=False,
          weight="default", bias_bound=None):
    fan_in = (cin // groups) * k
    bound = 1.0 / math.sqrt(fan_in)
    shape = (k, cin // groups, cout)
    if weight == "default":
        w = ("uniform", bound)
    elif weight.startswith("normal:"):
        w = ("normal", float(weight.split(":")[1]))
    else:
        raise ValueError(weight)
    if wn:
        leaves.append(Leaf(f"{name}.weight_v", shape, *w))
        leaves.append(Leaf(f"{name}.weight_g", (1, 1, cout), "norm_of",
                           of=f"{name}.weight_v"))
    else:
        leaves.append(Leaf(f"{name}.weight", shape, *w))
    if bias:
        leaves.append(Leaf(f"{name}.bias", (cout,), "uniform",
                           bias_bound if bias_bound is not None else bound))


def _norm(leaves, name, channels):
    leaves.append(Leaf(f"{name}.gamma", (channels,), "ones"))
    leaves.append(Leaf(f"{name}.beta", (channels,), "zeros"))


def _dds(leaves, name, channels):
    for i in range(SDP_DDS_LAYERS):
        _conv(leaves, f"{name}.convs_sep.{i}", channels, channels, SDP_KERNEL,
              groups=channels)
        _conv(leaves, f"{name}.convs_1x1.{i}", channels, channels, 1)
        _norm(leaves, f"{name}.norms_1.{i}", channels)
        _norm(leaves, f"{name}.norms_2.{i}", channels)


def _hifigan_stages(leaves, m, ch, rates, kernels):
    gain = math.sqrt(2.0 / (1.0 + 0.1 ** 2))  # He, leaky ReLU of 0.1
    for i, (u, k) in enumerate(zip(rates, kernels)):
        out = ch // 2
        # ConvTranspose1d: torch's fan-in is weight.size(1) * K = Cout * K
        _conv(leaves, f"dec.ups.{i}", ch, out, k, wn=True,
              weight=f"normal:{gain / math.sqrt(ch * k / u)}",
              bias_bound=1.0 / math.sqrt(out * k))
        for j, (rk, rd) in enumerate(zip(m["resblock_kernel_sizes"],
                                         m["resblock_dilation_sizes"])):
            for key in ("convs1", "convs2"):
                for jj in range(len(rd)):
                    _conv(leaves, f"dec.resblocks.{i * 3 + j}.{key}.{jj}",
                          out, out, rk, wn=True, weight="normal:0.01")
        ch = out
    return ch


def layout(m: typing.Mapping[str, typing.Any]) -> typing.List[Leaf]:
    """Every leaf of the voice file for model settings ``m`` (the
    ``model`` section of a voice's ``config.json``)."""
    if m.get("n_speakers", 1) > 1 or m.get("gin_channels", 0):
        raise ValueError("multi-speaker voices are outside the reference")
    if not m.get("use_sdp", True) or m.get("resblock", "1") != "1":
        raise ValueError("the reference runs the SDP with ResBlock1 only")
    h, inter, f = m["hidden_channels"], m["inter_channels"], \
        m["filter_channels"]
    heads = m["n_heads"]
    leaves: typing.List[Leaf] = [
        Leaf("enc_p.emb.weight", (m["num_symbols"], h), "normal", h ** -0.5)
    ]
    for i in range(m["n_layers"]):
        a = f"enc_p.attn_layers.{i}"
        for c in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _conv(leaves, f"{a}.{c}", h, h, 1)
        for e in ("emb_rel_k", "emb_rel_v"):
            leaves.append(Leaf(f"{a}.{e}", (1, 2 * REL_WINDOW + 1, h // heads),
                               "normal", (h // heads) ** -0.5))
        _norm(leaves, f"enc_p.norm_layers_1.{i}", h)
        _conv(leaves, f"enc_p.ffn_layers.{i}.conv_1", h, f, m["kernel_size"])
        _conv(leaves, f"enc_p.ffn_layers.{i}.conv_2", f, h, m["kernel_size"])
        _norm(leaves, f"enc_p.norm_layers_2.{i}", h)
    _conv(leaves, "enc_p.proj", h, 2 * inter, 1)

    _conv(leaves, "dp.pre", h, SDP_FILTER, 1)
    _conv(leaves, "dp.proj", SDP_FILTER, SDP_FILTER, 1)
    _dds(leaves, "dp.convs", SDP_FILTER)
    leaves.append(Leaf("dp.flows.0.m", (2,), "zeros"))
    leaves.append(Leaf("dp.flows.0.logs", (2,), "zeros"))
    for i in SDP_CONV_FLOWS:
        _conv(leaves, f"dp.flows.{i}.pre", 1, SDP_FILTER, 1)
        _dds(leaves, f"dp.flows.{i}.convs", SDP_FILTER)
        _conv(leaves, f"dp.flows.{i}.proj", SDP_FILTER, 3 * SDP_BINS - 1, 1,
              weight="normal:0.001", bias_bound=0.001)

    half = inter // 2
    for c in range(FLOW_COUPLINGS):
        p = f"flow.flows.{2 * c}"
        _conv(leaves, f"{p}.pre", half, h, 1)
        for j in range(WN_LAYERS):
            _conv(leaves, f"{p}.enc.in_layers.{j}", h, 2 * h, WN_KERNEL,
                  wn=True)
            _conv(leaves, f"{p}.enc.res_skip_layers.{j}", h,
                  2 * h if j < WN_LAYERS - 1 else h, 1, wn=True)
        _conv(leaves, f"{p}.post", h, half, 1)

    ch = m["upsample_initial_channel"]
    _conv(leaves, "dec.conv_pre", inter, ch, 7)
    if m.get("decoder_type", "hifigan") == "mb-istft":
        ch = _hifigan_stages(leaves, m, ch, m["mb_upsample_rates"],
                             m["mb_upsample_kernel_sizes"])
        _conv(leaves, "dec.conv_post", ch,
              m["subbands"] * 2 * (m["istft_n_fft"] // 2 + 1), 7)
    else:
        ch = _hifigan_stages(leaves, m, ch, m["upsample_rates"],
                             m["upsample_kernel_sizes"])
        _conv(leaves, "dec.conv_post", ch, 1, 7, bias=False)
    return leaves


def _is_transposed(name: str) -> bool:
    return ".ups." in f".{name}"


def load(path: typing.Union[str, Path], device: torch.device
         ) -> typing.Dict[str, torch.Tensor]:
    """The voice file as float32 torch tensors on ``device``, one per
    dotted path without the ``weight_v``/``weight_g`` split: weight norm
    folded (``g * v / ||v||``, the norm over all axes but the output
    channel), convolutions ``[Cout, Cin/groups, K]``, transposed
    convolutions ``[Cin, Cout, K]``."""
    out: typing.Dict[str, torch.Tensor] = {}
    with np.load(path) as data:
        arrays = {k: np.asarray(data[k], np.float32) for k in data.files}
    for name, arr in arrays.items():
        if name.endswith(".weight_g"):
            continue
        if name.endswith(".weight_v"):
            base = name[: -len(".weight_v")]
            g = arrays[f"{base}.weight_g"].astype(np.float64)
            v = arr.astype(np.float64)
            arr = (g * v / np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
                   ).astype(np.float32)
            name = f"{base}.weight"
        if name.endswith(".weight") and arr.ndim == 3:
            arr = arr.transpose((1, 2, 0) if _is_transposed(name)
                                else (2, 1, 0))
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out
