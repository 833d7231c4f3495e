"""HiFi-GAN decoder (vocoder): latent frames -> waveform.

Counterpart of ``mimic3_tpu/models/vits/hifigan.py`` in ``[B, C, T]``
layout.  Stages whose channel count is at most ``stage_max_channels`` run
as one fused kernel launch (``ops/stage.py``) with the upsampler fused
before them and, on the last stage, the ``conv_post`` head fused after;
the other stages are plain ``F.conv1d`` / ``F.conv_transpose1d``.
"""

from __future__ import annotations

import typing

import torch

from ...ops.stage import (
    SUPPORTED_CHANNELS,
    StageWeights,
    hifigan_stage_fused,
    pack_stage_weights,
)
from .layers import (
    LRELU_SLOPE,
    Params,
    conv1d,
    conv_transpose1d,
    leaky_relu,
)


def resblock1(
    params: Params,
    x: torch.Tensor,
    kernel_size: int,
    dilations: typing.Sequence[int],
) -> torch.Tensor:
    """HiFi-GAN ResBlock1: (lrelu -> dilated conv -> lrelu -> conv) x3."""
    for j, d in enumerate(dilations):
        sj = str(j)
        xt = conv1d(
            leaky_relu(x, LRELU_SLOPE),
            params["convs1"][sj],
            padding=(kernel_size * d - d) // 2,
            dilation=d,
        )
        xt = conv1d(
            leaky_relu(xt, LRELU_SLOPE),
            params["convs2"][sj],
            padding=(kernel_size - 1) // 2,
        )
        x = x + xt
    return x


def resblock2(
    params: Params,
    x: torch.Tensor,
    kernel_size: int,
    dilations: typing.Sequence[int],
) -> torch.Tensor:
    """HiFi-GAN ResBlock2: (lrelu -> dilated conv) per dilation."""
    for j, d in enumerate(dilations):
        xt = conv1d(
            leaky_relu(x, LRELU_SLOPE),
            params["convs"][str(j)],
            padding=(kernel_size * d - d) // 2,
            dilation=d,
        )
        x = x + xt
    return x


def fused_stages(
    params: Params,
    *,
    resblock_type: str,
    resblock_kernel_sizes: typing.Sequence[int],
    resblock_dilation_sizes: typing.Sequence[typing.Sequence[int]],
    upsample_rates: typing.Sequence[int],
    upsample_kernel_sizes: typing.Sequence[int],
    stage_max_channels: int,
) -> typing.List[int]:
    """Indices of the stages that run as one fused kernel launch.

    The decision is a shape predicate: ResBlock1 stages whose channel
    count is at most ``stage_max_channels`` and one the kernel is built
    for, with all resblocks sharing the number of dilation steps.
    """
    if resblock_type != "1" or stage_max_channels <= 0:
        return []
    n_steps = {len(d) for d in resblock_dilation_sizes}
    if len(n_steps) != 1:
        return []
    out = []
    for i in range(len(upsample_rates)):
        c_out = params["ups"][str(i)]["weight"].shape[1]
        if c_out <= stage_max_channels and c_out in SUPPORTED_CHANNELS:
            out.append(i)
    return out


def pack_stages(
    params: Params,
    stages: typing.Sequence[int],
    *,
    resblock_kernel_sizes: typing.Sequence[int],
    resblock_dilation_sizes: typing.Sequence[typing.Sequence[int]],
    upsample_rates: typing.Sequence[int],
    upsample_kernel_sizes: typing.Sequence[int],
    device: torch.device,
    dtype: torch.dtype,
) -> typing.Dict[int, StageWeights]:
    """Kernel weight packs of the fused stages, built once per voice for
    the decoder's ``dtype``."""
    n_kernels = len(resblock_kernel_sizes)
    last = len(upsample_rates) - 1
    return {
        i: pack_stage_weights(
            [
                params["resblocks"][str(i * n_kernels + j)]
                for j in range(n_kernels)
            ],
            resblock_kernel_sizes,
            resblock_dilation_sizes,
            ups_params=params["ups"][str(i)],
            ups_stride=upsample_rates[i],
            ups_padding=(upsample_kernel_sizes[i] - upsample_rates[i]) // 2,
            post_params=params["conv_post"] if i == last else None,
            device=device,
            dtype=dtype,
        )
        for i in stages
    }


def hifigan_generator(
    params: Params,
    x: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    *,
    resblock_type: str = "1",
    resblock_kernel_sizes: typing.Sequence[int] = (3, 7, 11),
    resblock_dilation_sizes: typing.Sequence[typing.Sequence[int]] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    ),
    upsample_rates: typing.Sequence[int] = (8, 8, 2, 2),
    upsample_kernel_sizes: typing.Sequence[int] = (16, 16, 4, 4),
    compute_dtype: torch.dtype = torch.float32,
    stage_max_channels: int = 0,
    stage_weights: typing.Optional[typing.Mapping[int, StageWeights]] = None,
) -> torch.Tensor:
    """Decode latent frames [B, inter, F] to a waveform [B, F*prod(rates)].

    The final conv + tanh run in float32 regardless of ``compute_dtype``.
    ``stage_weights`` holds the fused stages' packed weights
    (:func:`pack_stages`); without it they are packed on the call.
    """
    x = conv1d(x.to(compute_dtype), params["conv_pre"], padding=3)
    if g is not None and "cond" in params:
        x = x + conv1d(g.to(compute_dtype), params["cond"])

    num_kernels = len(resblock_kernel_sizes)
    res_fn = resblock1 if resblock_type == "1" else resblock2
    fused = fused_stages(
        params,
        resblock_type=resblock_type,
        resblock_kernel_sizes=resblock_kernel_sizes,
        resblock_dilation_sizes=resblock_dilation_sizes,
        upsample_rates=upsample_rates,
        upsample_kernel_sizes=upsample_kernel_sizes,
        stage_max_channels=stage_max_channels,
    )
    last = len(upsample_rates) - 1
    for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
        stage_params = [
            params["resblocks"][str(i * num_kernels + j)]
            for j in range(num_kernels)
        ]
        if i in fused:
            x = hifigan_stage_fused(
                stage_params,
                x.contiguous(),
                resblock_kernel_sizes,
                resblock_dilation_sizes,
                ups_params=params["ups"][str(i)],
                ups_stride=u,
                ups_padding=(k - u) // 2,
                post_params=params["conv_post"] if i == last else None,
                weights=None if stage_weights is None else stage_weights[i],
            )
            if i == last:
                return x  # [B, samples] float32 waveform
            continue
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
            out = res_fn(stage_params[j], x, rk, rd)
            xs = out if xs is None else xs + out
        x = xs / num_kernels

    x = leaky_relu(x.float(), LRELU_SLOPE)
    x = conv1d(x, params["conv_post"], padding=3, dtype=torch.float32)
    return torch.tanh(x)[:, 0]
