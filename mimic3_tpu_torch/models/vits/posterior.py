"""Posterior encoder (training only): linear spectrogram -> latent z.

Counterpart of ``mimic3_tpu/models/vits/posterior.py`` in ``[B, C, T]``
layout.  VITS's ``enc_q``: 1x1 pre-projection, a 16-layer WaveNet stack,
and a projection to (m_q, logs_q); z ~ N(m_q, exp(logs_q)).  Exists only
at training time; synthesis samples the prior instead.
"""

from __future__ import annotations

import typing

import torch

from .flow import wavenet
from .layers import Params, conv1d

POSTERIOR_WN_LAYERS = 16
POSTERIOR_WN_KERNEL = 5


def init_posterior_encoder(
    ini,
    spec_channels: int,
    inter_channels: int,
    hidden_channels: int,
    gin_channels: int = 0,
    n_layers: int = POSTERIOR_WN_LAYERS,
) -> Params:
    """Random ``enc_q`` parameters in the JAX package's layout, drawn by
    ``ini`` (a :class:`~.model._Init`)."""
    from .model import _init_wavenet

    return {
        "pre": ini.conv(spec_channels, hidden_channels, 1),
        "enc": _init_wavenet(
            ini, hidden_channels, POSTERIOR_WN_KERNEL, n_layers, gin_channels
        ),
        "proj": ini.conv(hidden_channels, inter_channels * 2, 1),
    }


def posterior_encoder(
    params: Params,
    spec: torch.Tensor,
    y_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    *,
    noise: typing.Optional[torch.Tensor] = None,
    generator: typing.Optional[torch.Generator] = None,
    n_layers: int = POSTERIOR_WN_LAYERS,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """spec: [B, n_bins, T] -> (z, m_q, logs_q), all [B, C, T].

    ``noise`` [B, C, T] is the standard normal draw of the sample (the
    reference's posterior.py:66); without it the draw comes from
    ``generator``.
    """
    h = conv1d(spec, params["pre"]) * y_mask
    h = wavenet(
        params["enc"],
        h,
        y_mask,
        g=g,
        kernel_size=POSTERIOR_WN_KERNEL,
        n_layers=n_layers,
    )
    stats = conv1d(h, params["proj"]) * y_mask
    inter = stats.shape[1] // 2
    m_q, logs_q = stats[:, :inter], stats[:, inter:]
    if noise is None:
        noise = torch.randn(
            m_q.shape, generator=generator, device=m_q.device,
            dtype=m_q.dtype,
        )
    z = (m_q + noise * torch.exp(logs_q)) * y_mask
    return z, m_q, logs_q
