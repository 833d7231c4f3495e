"""GAN discriminators for VITS training (HiFi-GAN style).

Counterpart of ``mimic3_tpu/models/vits/discriminator.py`` in PyTorch's
layouts (NCHW / ``[Cout, Cin, kh, kw]`` for the 2-D convs):

- multi-period discriminator (MPD): reshapes the waveform into 2-D
  [frames/p, p] grids for p in (2, 3, 5, 7, 11) and runs strided 2-D
  convs (catches periodic artifacts),
- scale discriminator (DiscriminatorS): strided/grouped 1-D convs on the
  raw waveform (VITS uses one scale, not HiFi-GAN's three).

Every conv is weight-normed (``weight_v``/``weight_g``).  Waveforms are
``[B, samples]``.  Parameters are drawn in the JAX package's layout and
carried to torch's by ``runtime/convert.py::to_torch_train_params``.
"""

from __future__ import annotations

import typing

import torch
import torch.nn.functional as F

from .layers import LRELU_SLOPE, Params, conv1d, conv_weight, leaky_relu

PERIODS = (2, 3, 5, 7, 11)

_P_CHANNELS = (32, 128, 512, 1024)

_S_SPECS = (
    # (cout, kernel, stride, groups, padding)
    (16, 15, 1, 1, 7),
    (64, 41, 4, 4, 20),
    (256, 41, 4, 16, 20),
    (1024, 41, 4, 64, 20),
    (1024, 41, 4, 256, 20),
    (1024, 5, 1, 1, 2),
)


def _conv2d(
    x: torch.Tensor,
    p: Params,
    stride: typing.Tuple[int, int] = (1, 1),
    padding: typing.Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """x: [B, C, H, W]; weight: [Cout, Cin, kh, kw]."""
    return F.conv2d(
        x, conv_weight(p).to(x.dtype), p.get("bias"), stride=stride,
        padding=padding,
    )


# ---------------------------------------------------------------------------
# Initialization (JAX layout)
# ---------------------------------------------------------------------------


def init_period_discriminator(ini, kernel: int = 5) -> Params:
    chans = [1, *_P_CHANNELS]
    convs = {
        str(i): ini.conv2d(chans[i], chans[i + 1], kernel, 1)
        for i in range(len(chans) - 1)
    }
    convs[str(len(chans) - 1)] = ini.conv2d(_P_CHANNELS[-1], 1024, kernel, 1)
    return {"convs": convs, "conv_post": ini.conv2d(1024, 1, 3, 1)}


def init_scale_discriminator(ini) -> Params:
    convs = {}
    cin = 1
    for i, (cout, k, _s, groups, _p) in enumerate(_S_SPECS):
        convs[str(i)] = ini.conv(cin, cout, k, groups=groups, weight_norm=True)
        cin = cout
    return {
        "convs": convs,
        "conv_post": ini.conv(1024, 1, 3, weight_norm=True),
    }


def init_discriminators(ini) -> Params:
    """MSD + one MPD head per period, drawn by ``ini`` (a
    :class:`~.model._Init`)."""
    return {
        "msd": init_scale_discriminator(ini),
        "mpd": {str(p): init_period_discriminator(ini) for p in PERIODS},
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def period_discriminator(
    params: Params, audio: torch.Tensor, period: int, kernel: int = 5
) -> typing.Tuple[torch.Tensor, typing.List[torch.Tensor]]:
    """audio: [B, samples] -> (logits [B, N], feature maps)."""
    b, n = audio.shape
    pad = (period - n % period) % period
    x = audio
    if pad:
        x = F.pad(audio[:, None], (0, pad), mode="reflect")[:, 0]
    x = x.reshape(b, 1, -1, period)  # [B, 1, frames, period]

    fmaps: typing.List[torch.Tensor] = []
    n_convs = len(params["convs"])
    for i in range(n_convs):
        stride = (3, 1) if i < n_convs - 1 else (1, 1)
        x = _conv2d(
            x, params["convs"][str(i)], stride=stride,
            padding=((kernel - 1) // 2, 0),
        )
        x = leaky_relu(x, LRELU_SLOPE)
        fmaps.append(x)
    x = _conv2d(x, params["conv_post"], padding=(1, 0))
    fmaps.append(x)
    return x.reshape(b, -1), fmaps


def scale_discriminator(
    params: Params, audio: torch.Tensor
) -> typing.Tuple[torch.Tensor, typing.List[torch.Tensor]]:
    b = audio.shape[0]
    x = audio[:, None]  # [B, 1, samples]
    fmaps: typing.List[torch.Tensor] = []
    for i, (_c, _k, stride, groups, padding) in enumerate(_S_SPECS):
        x = conv1d(
            x, params["convs"][str(i)], stride=stride, padding=padding,
            groups=groups,
        )
        x = leaky_relu(x, LRELU_SLOPE)
        fmaps.append(x)
    x = conv1d(x, params["conv_post"], padding=1)
    fmaps.append(x)
    return x.reshape(b, -1), fmaps


def discriminate(
    params: Params, audio: torch.Tensor
) -> typing.Tuple[
    typing.List[torch.Tensor], typing.List[typing.List[torch.Tensor]]
]:
    """All discriminator heads: returns (logits list, feature-map lists)."""
    logits, fmaps = [], []
    out, fm = scale_discriminator(params["msd"], audio)
    logits.append(out)
    fmaps.append(fm)
    for p in PERIODS:
        out, fm = period_discriminator(params["mpd"][str(p)], audio, p)
        logits.append(out)
        fmaps.append(fm)
    return logits, fmaps
