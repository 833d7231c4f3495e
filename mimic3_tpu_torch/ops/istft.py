"""Inverse STFT and pseudo-QMF filterbanks (MB-iSTFT decoder support).

Port copy of ``mimic3_tpu/ops/istft.py`` with the same interfaces
(``[B, T, C]`` in and out, as the reference's).  The multi-band iSTFT
VITS variant (arXiv 2210.15975) predicts a small magnitude/phase STFT per
sub-band; each sub-band is inverted with an iSTFT and a fixed pseudo-QMF
synthesis filterbank upsamples and combines the bands.

iSTFT is a matrix product against the inverse DFT basis plus an
overlap-add of shifted pieces; PQMF synthesis zero-stuffs the bands and
runs one convolution.  The fixed arrays (basis, window, window-sum
normalization, filters) are numpy, computed once per shape and copied to
each device once.
"""

from __future__ import annotations

import functools
import threading
import typing

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _inverse_basis(n_fft: int) -> np.ndarray:
    """Real inverse-DFT basis: [2*(n_fft//2+1), n_fft]."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[None, :]
    k = np.arange(n_bins)[:, None]
    angles = 2.0 * np.pi * k * t / n_fft
    # irfft weighting: DC and nyquist count once, others twice
    weights = np.full((n_bins, 1), 2.0)
    weights[0] = 1.0
    if n_fft % 2 == 0:
        weights[-1] = 1.0
    cos = np.cos(angles) * weights / n_fft
    sin = -np.sin(angles) * weights / n_fft
    return np.concatenate([cos, sin], axis=0).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _window(n_fft: int, win_length: int) -> np.ndarray:
    """Periodic Hann window of ``win_length``, centered in ``n_fft``."""
    window = np.hanning(win_length + 1)[:-1].astype(np.float32)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = np.pad(window, (pad, n_fft - win_length - pad))
    return window


@functools.lru_cache(maxsize=64)
def _window_sum(
    frames: int, n_fft: int, hop_length: int, win_length: int
) -> np.ndarray:
    """Overlap-added squared window (the iSTFT's normalization), floored
    at 1e-8: a static array per (frames, n_fft, hop, win)."""
    w2 = np.square(_window(n_fft, win_length)).astype(np.float32)
    wsum = np.zeros(frames * hop_length + (n_fft - hop_length), np.float32)
    # frame f adds w2 at f*hop: add each hop-sized piece r of w2 to every
    # frame at once, last piece first (the frame-by-frame sum's order)
    for r in reversed(range(n_fft // hop_length)):
        piece = w2[r * hop_length : (r + 1) * hop_length]
        wsum[r * hop_length : r * hop_length + frames * hop_length] += (
            np.tile(piece, frames)
        )
    return np.maximum(wsum, 1e-8)


_DEVICE_CACHE: typing.Dict[typing.Tuple, torch.Tensor] = {}
_DEVICE_CACHE_LOCK = threading.Lock()


def _on_device(
    key: typing.Tuple, make: typing.Callable[[], np.ndarray],
    device: torch.device,
) -> torch.Tensor:
    """A fixed numpy array as a float32 tensor on ``device``, copied there
    once per (key, device) so the decode enqueues no host copy."""
    full_key = key + (str(device),)
    with _DEVICE_CACHE_LOCK:
        cached = _DEVICE_CACHE.get(full_key)
    if cached is None:
        cached = torch.from_numpy(np.ascontiguousarray(make())).to(device)
        with _DEVICE_CACHE_LOCK:
            if len(_DEVICE_CACHE) > 256:
                _DEVICE_CACHE.clear()
            _DEVICE_CACHE[full_key] = cached
    return cached


def istft(
    real: torch.Tensor,
    imag: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: typing.Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT with a Hann window and overlap-add.

    real/imag: [B, frames, n_fft//2+1] -> audio [B, frames*hop], float32.
    center=False framing; the window-sum normalization assumes
    hop <= win/2, with edge frames normalized by the actual overlap.
    """
    if win_length is None:
        win_length = n_fft
    b, frames, _ = real.shape
    dev = real.device

    basis = _on_device(("basis", n_fft), lambda: _inverse_basis(n_fft), dev)
    window = _on_device(
        ("window", n_fft, win_length), lambda: _window(n_fft, win_length), dev
    )
    spec = torch.cat([real, imag], dim=-1).float()  # [B, F, 2nb]
    frames_t = torch.matmul(spec, basis) * window  # [B, F, n_fft]

    out_len = frames * hop_length + (n_fft - hop_length)
    # overlap-add: n_fft/hop is an integer ratio R; split each frame into
    # R hop-sized pieces, flatten, and add them shifted by r*hop
    ratio = n_fft // hop_length
    audio = None
    for r in range(ratio):
        piece = frames_t[:, :, r * hop_length : (r + 1) * hop_length]
        flat = piece.reshape(b, frames * hop_length)
        left = r * hop_length
        shifted = F.pad(flat, (left, out_len - left - frames * hop_length))
        audio = shifted if audio is None else audio + shifted

    wsum = _on_device(
        ("wsum", frames, n_fft, hop_length, win_length),
        lambda: _window_sum(frames, n_fft, hop_length, win_length),
        dev,
    )
    audio = audio / wsum

    # trim the centering padding: keep frames*hop samples starting at
    # (n_fft - hop)/2
    start = (n_fft - hop_length) // 2
    return audio[:, start : start + frames * hop_length]


# ---------------------------------------------------------------------------
# Pseudo-QMF filterbank
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def pqmf_filters(
    subbands: int = 4,
    taps: int = 62,
    cutoff: float = 0.142,
    beta: float = 9.0,
):
    """Cosine-modulated pseudo-QMF bank.

    Returns (analysis, synthesis), each [subbands, taps+1].  Prototype:
    Kaiser-windowed lowpass with ``cutoff`` relative to Nyquist (the
    near-perfect-reconstruction optimum for 4 bands / 62 taps).
    Analysis/synthesis differ by the sign of the (-1)^k * pi/4 phase —
    the pair property that cancels aliasing between adjacent bands.
    """
    n = np.arange(taps + 1) - taps / 2.0
    h = cutoff * np.sinc(cutoff * n)  # lowpass, cutoff rel. to Nyquist
    h *= np.kaiser(taps + 1, beta)

    k = np.arange(subbands)[:, None]
    t = np.arange(taps + 1)[None, :]
    theta = (2 * k + 1) * np.pi / (2 * subbands) * (t - taps / 2.0)
    shift = ((-1.0) ** k) * np.pi / 4
    analysis = 2 * h[None, :] * np.cos(theta + shift)
    synthesis = 2 * h[None, :] * np.cos(theta - shift)
    return (
        analysis.astype(np.float32),
        synthesis.astype(np.float32),
    )


PQMF_TAPS = 62


def pqmf_analysis(
    audio: torch.Tensor, subbands: int = 4, taps: int = PQMF_TAPS
) -> torch.Tensor:
    """Split audio [B, T] into critically-sampled sub-bands
    [B, T//subbands, subbands] (training-side targets)."""
    analysis, _ = pqmf_filters(subbands, taps)
    # a convolution with each analysis filter: conv1d cross-correlates,
    # so its weight [S, 1, K] is the flipped filter (as the reference's)
    w = _on_device(
        ("pqmf_analysis", subbands, taps),
        lambda: np.flip(analysis, axis=1)[:, None, :], audio.device,
    )
    pad = taps // 2
    out = F.conv1d(audio.float()[:, None, :], w, stride=subbands, padding=pad)
    return out.transpose(1, 2)


def pqmf_synthesis(
    bands: torch.Tensor, subbands: int = 4, taps: int = PQMF_TAPS
) -> torch.Tensor:
    """Combine sub-bands [B, T, subbands] -> waveform [B, T*subbands].

    Zero-stuff each band by ``subbands``, filter with its synthesis
    filter, sum bands, and scale by ``subbands`` (zero-stuffing energy).
    End-to-end analysis->synthesis has a ``taps``-sample group delay.
    """
    _, synthesis = pqmf_filters(subbands, taps)
    # a convolution with each synthesis filter, summed over bands:
    # weight [1, S, K] is the flipped filter (as the reference's)
    w = _on_device(
        ("pqmf_synthesis", subbands, taps),
        lambda: np.flip(synthesis, axis=1)[None, :, :], bands.device,
    )
    b, t, s = bands.shape
    stuffed = bands.new_zeros((b, s, t * subbands))
    stuffed[:, :, ::subbands] = bands.transpose(1, 2)
    # the reference's lhs-dilated input is (t-1)*S+1 long, padded by
    # (pad, pad + S - 1): zero-stuffing to t*S gives the S-1 right zeros
    pad = taps // 2
    out = F.conv1d(F.pad(stuffed.float(), (pad, pad)), w)
    return out[:, 0] * subbands
