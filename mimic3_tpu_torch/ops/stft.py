"""Spectrogram / mel ops for VITS training.

Counterpart of ``mimic3_tpu/ops/stft.py``, with the same conventions
(filter_length 1024, hop 256, win 1024, mel 80; reference:
mimic3_tts/config.py:34-38):

- STFT with a periodic Hann window, reflect-padded by ``(n_fft - hop) //
  2``, center=False framing (torch.stft-compatible for these settings),
- linear magnitude spectrogram (the posterior encoder's input),
- slaney-scaled, slaney-normalized mel filterbank (librosa-compatible),
- dynamic-range compression ``log(clamp(x, 1e-5))``.

Framing is a strided view of the padded audio and the DFT a product with
the windowed basis, as in the reference.  The products run in float32:
the caller turns TF32 off (``models/vits/train.py``), the counterpart of
the reference's ``Precision.HIGHEST``.  Spectrograms come out in the
port's ``[B, bins, frames]`` layout.
"""

from __future__ import annotations

import functools
import typing

import numpy as np
import torch
import torch.nn.functional as F

from .istft import _on_device


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed real-DFT basis: [n_fft, 2*(n_fft//2+1)] (re, im stacked)."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[None, :]
    k = np.arange(n_bins)[:, None]
    angles = -2.0 * np.pi * k * t / n_fft
    window = np.hanning(win_length + 1)[:-1]  # periodic hann
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = np.pad(window, (pad, n_fft - win_length - pad))
    basis = np.concatenate(
        [np.cos(angles), np.sin(angles)], axis=0
    )  # [2*n_bins, n_fft]
    return (basis * window[None, :]).T.astype(np.float32)  # [n_fft, 2nb]


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: typing.Optional[float] = None,
) -> np.ndarray:
    """Slaney-style mel filterbank [n_bins, n_mels] (librosa-compatible)."""
    if fmax is None:
        fmax = sample_rate / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        # slaney: linear below 1 kHz, log above
        mel = f / (200.0 / 3)
        log_region = f >= 1000.0
        return np.where(
            log_region,
            15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
            mel,
        )

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = m * (200.0 / 3)
        log_region = m >= 15.0
        return np.where(
            log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f
        )

    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_points = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_points = mel_to_hz(mel_points)

    fb = np.zeros((n_bins, n_mels), dtype=np.float64)
    for m in range(n_mels):
        left, center, right = hz_points[m : m + 3]
        up = (fft_freqs - left) / max(center - left, 1e-10)
        down = (right - fft_freqs) / max(right - center, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
        # slaney normalization: constant energy per channel
        fb[:, m] *= 2.0 / (right - left)
    return fb.astype(np.float32)


def spectrogram(
    audio: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
) -> torch.Tensor:
    """Linear magnitude spectrogram.

    audio: [B, samples] -> [B, n_fft//2+1, frames], where frames =
    samples // hop_length (torch.stft center=False after the reflect
    padding VITS applies).
    """
    pad = (n_fft - hop_length) // 2
    x = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(1, n_fft, hop_length)  # [B, frames, n_fft], a view
    basis = _on_device(
        ("dft", n_fft, win_length), lambda: _dft_basis(n_fft, win_length),
        x.device,
    )
    proj = torch.matmul(frames, basis)  # [B, frames, 2*n_bins]
    n_bins = n_fft // 2 + 1
    re, im = proj[..., :n_bins], proj[..., n_bins:]
    return torch.sqrt(re * re + im * im + 1e-6).transpose(1, 2)


def mel_spectrogram(
    audio: torch.Tensor,
    sample_rate: int = 22050,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: typing.Optional[float] = None,
) -> torch.Tensor:
    """Log-mel spectrogram [B, n_mels, frames]."""
    spec = spectrogram(audio, n_fft, hop_length, win_length)
    return spec_to_mel(spec, sample_rate, n_fft, n_mels, fmin, fmax)


def spec_to_mel(
    spec: torch.Tensor,
    sample_rate: int = 22050,
    n_fft: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: typing.Optional[float] = None,
) -> torch.Tensor:
    """Linear spectrogram [B, bins, frames] -> compressed log-mel
    [B, n_mels, frames]."""
    fb = _on_device(
        ("mel", sample_rate, n_fft, n_mels, fmin, fmax),
        lambda: mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax),
        spec.device,
    )
    mel = torch.matmul(fb.t(), spec)
    return torch.log(torch.clamp(mel, min=1e-5))
