"""Multi-band iSTFT decoder (MB-iSTFT-VITS, arXiv 2210.15975).

Port copy of ``mimic3_tpu/models/vits/mbistft.py`` in ``[B, C, T]``
layout.  A second decoder family beside HiFi-GAN: two transposed-conv
upsampling stages (x16) with MRF resblocks (plain ``resblock1``, as the
reference's: no fused kernel), then a head that predicts a tiny
magnitude/phase STFT for each of 4 sub-bands; each band is inverted with
an iSTFT (x4) and a fixed pseudo-QMF synthesis filterbank combines the
bands (x4) — 16*4*4 = 256 = hop_length, like HiFi-GAN's 8*8*2*2, but the
conv stack stops at 1/16th of the sample rate.

Voices choose it with ``model.decoder_type: "mb-istft"`` in config.json.
"""

from __future__ import annotations

import math
import typing

import torch

from ...ops.istft import istft, pqmf_synthesis
from .hifigan import resblock1
from .layers import (
    LRELU_SLOPE,
    Params,
    conv1d,
    conv_transpose1d,
    leaky_relu,
)


def mb_istft_generator(
    params: Params,
    x: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    *,
    subbands: int = 4,
    istft_n_fft: int = 16,
    istft_hop: int = 4,
    resblock_kernel_sizes: typing.Sequence[int] = (3, 7, 11),
    resblock_dilation_sizes: typing.Sequence[typing.Sequence[int]] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    ),
    upsample_rates: typing.Sequence[int] = (4, 4),
    upsample_kernel_sizes: typing.Sequence[int] = (16, 16),
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Latent frames [B, inter, T] -> waveform [B, T*hop] float32.

    hop = prod(upsample_rates) * istft_hop * subbands.  The head
    (``conv_post``, the log-magnitude clip, the iSTFT and the PQMF) runs
    in float32 whatever ``compute_dtype``.
    """
    x = conv1d(x.to(compute_dtype), params["conv_pre"], padding=3)
    if g is not None and "cond" in params:
        x = x + conv1d(g.to(compute_dtype), params["cond"])

    num_kernels = len(resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
        x = conv_transpose1d(
            leaky_relu(x, LRELU_SLOPE),
            params["ups"][str(i)],
            stride=u,
            padding=(k - u) // 2,
        )
        xs = None
        for j, (rk, rd) in enumerate(
            zip(resblock_kernel_sizes, resblock_dilation_sizes)
        ):
            out = resblock1(
                params["resblocks"][str(i * num_kernels + j)], x, rk, rd
            )
            xs = out if xs is None else xs + out
        x = xs / num_kernels

    x = leaky_relu(x.float(), LRELU_SLOPE)
    n_bins = istft_n_fft // 2 + 1
    head = conv1d(
        x, params["conv_post"], padding=3, dtype=torch.float32
    )  # [B, subbands * 2 * n_bins, T16]

    b, _, t16 = head.shape
    head = head.reshape(b, subbands, 2, n_bins, t16)
    log_mag = torch.clamp(head[:, :, 0], -12.0, 6.0)
    phase = head[:, :, 1]
    mag = torch.exp(log_mag)
    # [B, S, n_bins, T16] -> bands folded into the batch [B*S, T16, n_bins]
    real = (mag * torch.cos(phase)).transpose(2, 3).reshape(
        b * subbands, t16, n_bins
    )
    imag = (mag * torch.sin(phase)).transpose(2, 3).reshape(
        b * subbands, t16, n_bins
    )
    band_audio = istft(real, imag, istft_n_fft, istft_hop)
    band_audio = band_audio.reshape(b, subbands, -1).transpose(1, 2)
    return pqmf_synthesis(band_audio, subbands)


def init_mb_istft(
    ini,
    inter_channels: int,
    *,
    initial_channel: int = 512,
    subbands: int = 4,
    istft_n_fft: int = 16,
    upsample_rates: typing.Sequence[int] = (4, 4),
    upsample_kernel_sizes: typing.Sequence[int] = (16, 16),
    resblock_kernel_sizes: typing.Sequence[int] = (3, 7, 11),
    resblock_dilation_sizes: typing.Sequence[typing.Sequence[int]] = (
        (1, 3, 5),
    ) * 3,
    gin_channels: int = 0,
) -> Params:
    """Decoder parameters with the reference's keys and shapes, drawn
    from ``ini`` (the model's seeded ``_Init``)."""
    p: Params = {
        "conv_pre": ini.conv(inter_channels, initial_channel, 7),
        "ups": {},
        "resblocks": {},
    }
    num_kernels = len(resblock_kernel_sizes)
    ch = initial_channel
    for i, (_u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
        out_ch = ch // 2
        p["ups"][str(i)] = ini.conv_transpose(ch, out_ch, k)
        for j, (rk, rd) in enumerate(
            zip(resblock_kernel_sizes, resblock_dilation_sizes)
        ):
            p["resblocks"][str(i * num_kernels + j)] = {
                key: {
                    str(jj): ini.conv(
                        out_ch, out_ch, rk, weight_norm=True, init="normal"
                    )
                    for jj in range(len(rd))
                }
                for key in ("convs1", "convs2")
            }
        ch = out_ch

    n_bins = istft_n_fft // 2 + 1
    post = ini.conv(ch, subbands * 2 * n_bins, 7)
    # start with tiny magnitudes so early training doesn't clip
    post["weight"] = post["weight"] * 0.01
    post["bias"] = post["bias"] * 0.0 - 2.0
    p["conv_post"] = post

    if gin_channels > 0:
        p["cond"] = ini.conv(gin_channels, initial_channel, 1)
    return p


def mb_istft_hop(
    upsample_rates: typing.Sequence[int],
    istft_hop: int,
    subbands: int,
) -> int:
    return int(math.prod(upsample_rates)) * istft_hop * subbands
