"""VITS inference, one utterance at a time, in plain PyTorch.

``Vits(model, params, device)`` runs the text encoder with windowed
relative attention, the stochastic duration predictor in reverse, the
mean-only coupling flow in reverse and the decoder (HiFi-GAN, or the
multi-band iSTFT decoder), all in float32 with TF32 off.  Activations
are ``[1, C, T]``; every length is the utterance's own, so no mask is
needed up to the decoder.  :meth:`Vits.decode` pads the latent with
``pad`` zero frames past the utterance before the decoder, as a batched
caller's bucket does (frames past the end are zero there too).

``precision="control"`` is the benchmark's control: the same forward
one step below what the configuration states, float32 with TF32 on
(matrix products and convolutions) up to the decoder and every decoder
convolution on float8 e4m3 inputs and weights (per-tensor scales,
float32 sums); the decoder's head stays in float32 as the program's
does.
"""

from __future__ import annotations

import contextlib
import math
import typing

import numpy as np
import torch
import torch.nn.functional as F

from . import noise as nz
from .params import (
    FLOW_COUPLINGS, REL_WINDOW, SDP_BINS, SDP_CONV_FLOWS, SDP_DDS_LAYERS,
    SDP_KERNEL, WN_KERNEL, WN_LAYERS,
)

LRELU_SLOPE = 0.1
SPLINE_TAIL = 5.0
MIN_BIN = 1e-3
MIN_DERIVATIVE = 1e-3
LOG_MAG_RANGE = (-12.0, 6.0)
PQMF_TAPS = 62
PQMF_CUTOFF = 0.142
PQMF_BETA = 9.0
FP8_MAX = 448.0


@contextlib.contextmanager
def _tf32(on: bool) -> typing.Iterator[None]:
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale."""
    amax = t.abs().max().clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


class Vits:
    def __init__(self, model: typing.Mapping[str, typing.Any],
                 params: typing.Mapping[str, torch.Tensor],
                 device: torch.device, precision: str = "float32"):
        if precision not in ("float32", "control"):
            raise ValueError(precision)
        self.m = dict(model)
        self.p = params
        self.device = device
        self.control = precision == "control"
        mb = self.m.get("decoder_type", "hifigan") == "mb-istft"
        self.is_mb = mb
        rates = self.m["mb_upsample_rates"] if mb else self.m["upsample_rates"]
        self.hop = math.prod(rates) * (
            self.m["istft_hop"] * self.m["subbands"] if mb else 1)

    # -- layers ---------------------------------------------------------------

    def conv(self, x, name, *, padding=0, dilation=1, groups=1, quant=False):
        w = self.p[f"{name}.weight"]
        b = self.p.get(f"{name}.bias")
        if quant and self.control:
            x, w = _fp8(x), _fp8(w)
        return F.conv1d(x, w, b, padding=padding, dilation=dilation,
                        groups=groups)

    def conv_t(self, x, name, stride, padding):
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        if self.control:
            x, w = _fp8(x), _fp8(w)
        return F.conv_transpose1d(x, w, b, stride=stride, padding=padding)

    def norm(self, x, name, eps=1e-5):
        g, b = self.p[f"{name}.gamma"], self.p[f"{name}.beta"]
        mean = x.mean(dim=1, keepdim=True)
        var = (x - mean).square().mean(dim=1, keepdim=True)
        return (x - mean) / torch.sqrt(var + eps) * g[:, None] + b[:, None]

    # -- text encoder -----------------------------------------------------------

    def attention(self, x, name):
        _, c, t = x.shape
        heads = self.m["n_heads"]
        d = c // heads

        def split(y):  # [1, C, T] -> [H, T, D], channel = head * D + d
            return y.reshape(heads, d, t).transpose(1, 2)

        q = split(self.conv(x, f"{name}.conv_q")) / math.sqrt(d)
        k = split(self.conv(x, f"{name}.conv_k"))
        v = split(self.conv(x, f"{name}.conv_v"))
        rel_k = self.p[f"{name}.emb_rel_k"][0]  # [2w+1, D]
        rel_v = self.p[f"{name}.emb_rel_v"][0]
        scores = q @ k.transpose(1, 2)  # [H, T, T]
        q_rel = q @ rel_k.t()  # [H, T, 2w+1]: query i against offset r
        for r in range(-REL_WINDOW, REL_WINDOW + 1):
            if abs(r) >= t:
                continue
            rows = slice(0, t - r) if r >= 0 else slice(-r, t)
            torch.diagonal(scores, offset=r, dim1=1, dim2=2).add_(
                q_rel[:, rows, r + REL_WINDOW])
        probs = torch.softmax(scores, dim=-1)
        out = probs @ v
        for r in range(-REL_WINDOW, REL_WINDOW + 1):
            if abs(r) >= t:
                continue
            rows = slice(0, t - r) if r >= 0 else slice(-r, t)
            weight = torch.diagonal(probs, offset=r, dim1=1, dim2=2)
            out[:, rows] += weight[..., None] * rel_v[r + REL_WINDOW]
        out = out.transpose(1, 2).reshape(1, c, t)
        return self.conv(out, f"{name}.conv_o")

    def encode(self, ids: typing.Sequence[int]):
        """``(x, m_p, logs_p)``, each ``[1, C, T]``."""
        h = self.m["hidden_channels"]
        ks = self.m["kernel_size"]
        idx = torch.tensor(list(ids), device=self.device)
        x = (self.p["enc_p.emb.weight"][idx] * math.sqrt(h)).t()[None]
        for i in range(self.m["n_layers"]):
            x = self.norm(x + self.attention(x, f"enc_p.attn_layers.{i}"),
                          f"enc_p.norm_layers_1.{i}")
            y = torch.relu(self.conv(x, f"enc_p.ffn_layers.{i}.conv_1",
                                     padding=ks // 2))
            y = self.conv(y, f"enc_p.ffn_layers.{i}.conv_2", padding=ks // 2)
            x = self.norm(x + y, f"enc_p.norm_layers_2.{i}")
        stats = self.conv(x, "enc_p.proj")
        inter = self.m["inter_channels"]
        return x, stats[:, :inter], stats[:, inter:]

    # -- stochastic duration predictor, reverse -----------------------------------

    def dds(self, x, name, g=None):
        if g is not None:
            x = x + g
        c = x.shape[1]
        for i in range(SDP_DDS_LAYERS):
            dil = SDP_KERNEL ** i
            y = self.conv(x, f"{name}.convs_sep.{i}", groups=c, dilation=dil,
                          padding=dil * (SDP_KERNEL - 1) // 2)
            y = F.gelu(self.norm(y, f"{name}.norms_1.{i}"))
            y = self.conv(y, f"{name}.convs_1x1.{i}")
            y = F.gelu(self.norm(y, f"{name}.norms_2.{i}"))
            x = x + y
        return x

    @staticmethod
    def _bins(unnormalized, min_size):
        sizes = min_size + (1 - min_size * SDP_BINS) * torch.softmax(
            unnormalized, dim=-1)
        edges = torch.cumsum(sizes, dim=-1) * 2 * SPLINE_TAIL - SPLINE_TAIL
        edges = torch.cat([torch.full_like(edges[..., :1], -SPLINE_TAIL),
                           edges[..., :-1],
                           torch.full_like(edges[..., :1], SPLINE_TAIL)], -1)
        return edges, edges[..., 1:] - edges[..., :-1]

    def spline_inverse(self, y, uw, uh, ud):
        """Inverse of the monotonic rational-quadratic spline on
        [-5, 5] with linear tails (Durkan et al., arXiv 1906.04032)."""
        inside = (y >= -SPLINE_TAIL) & (y <= SPLINE_TAIL)
        yc = y.clamp(-SPLINE_TAIL, SPLINE_TAIL)
        xe, w = self._bins(uw, MIN_BIN)
        ye, hgt = self._bins(uh, MIN_BIN)
        edge = math.log(math.expm1(1 - MIN_DERIVATIVE))
        ud = F.pad(ud, (1, 1), value=edge)
        deriv = MIN_DERIVATIVE + F.softplus(ud)
        k = torch.searchsorted(ye[..., 1:-1].contiguous(),
                               yc[..., None].contiguous(), right=True)
        pick = lambda t: torch.gather(t, -1, k)[..., 0]  # noqa: E731
        x_k, w_k, y_k, h_k = pick(xe), pick(w), pick(ye), pick(hgt)
        d0, d1 = pick(deriv), pick(deriv[..., 1:])
        delta = h_k / w_k
        dy = yc - y_k
        s = d0 + d1 - 2 * delta
        a = dy * s + h_k * (delta - d0)
        b = h_k * d0 - dy * s
        c = -delta * dy
        theta = 2 * c / (-b - torch.sqrt(torch.clamp(b * b - 4 * a * c,
                                                     min=0.0)))
        return torch.where(inside, theta * w_k + x_k, y)

    def log_durations(self, x, seed: int, noise_w: float):
        """``log w`` per phoneme, ``[T]``."""
        t = x.shape[-1]
        cond = self.conv(x, "dp.pre")
        cond = self.conv(self.dds(cond, "dp.convs"), "dp.proj")
        z = nz.positions(seed, nz.DURATION_STREAM, t, 2).t()[None].to(
            self.device) * noise_w
        filt = self.p["dp.pre.weight"].shape[0]
        for i in reversed(SDP_CONV_FLOWS):
            z = torch.flip(z, dims=[1])
            name = f"dp.flows.{i}"
            h = self.conv(z[:, :1], f"{name}.pre")
            h = self.conv(self.dds(h, f"{name}.convs", g=cond),
                          f"{name}.proj")
            h = h.reshape(1, 1, 3 * SDP_BINS - 1, t).permute(0, 1, 3, 2)
            x1 = self.spline_inverse(z[:, 1:], h[..., :SDP_BINS] /
                                     math.sqrt(filt),
                                     h[..., SDP_BINS:2 * SDP_BINS] /
                                     math.sqrt(filt),
                                     h[..., 2 * SDP_BINS:])
            z = torch.cat([z[:, :1], x1], dim=1)
        z = torch.flip(z, dims=[1])
        m, logs = self.p["dp.flows.0.m"], self.p["dp.flows.0.logs"]
        z = (z - m[:, None]) * torch.exp(-logs[:, None])
        return z[0, 0]

    def durations(self, ids, seed: int, length_scale: float, noise_w: float):
        """``(w, m_p, logs_p)``: the unrounded frame counts per phoneme
        (float64 on the host; the frame count is their ceiling) and the
        encoder's prior statistics."""
        with torch.inference_mode(), _tf32(self.control):
            x, m_p, logs_p = self.encode(ids)
            logw = self.log_durations(x, seed, noise_w)
            w = torch.exp(logw) * length_scale
        return w.double().cpu().numpy(), m_p, logs_p

    # -- flow, reverse --------------------------------------------------------

    def wavenet(self, x, name):
        h = x.shape[1]
        out = torch.zeros_like(x)
        for j in range(WN_LAYERS):
            a = self.conv(x, f"{name}.in_layers.{j}",
                          padding=(WN_KERNEL - 1) // 2)
            acts = torch.tanh(a[:, :h]) * torch.sigmoid(a[:, h:])
            rs = self.conv(acts, f"{name}.res_skip_layers.{j}")
            if j < WN_LAYERS - 1:
                x = x + rs[:, :h]
                out = out + rs[:, h:]
            else:
                out = out + rs
        return out

    def flow_reverse(self, z):
        half = z.shape[1] // 2
        for c in reversed(range(FLOW_COUPLINGS)):
            z = torch.flip(z, dims=[1])
            name = f"flow.flows.{2 * c}"
            h = self.wavenet(self.conv(z[:, :half], f"{name}.pre"),
                             f"{name}.enc")
            z = torch.cat([z[:, :half],
                           z[:, half:] - self.conv(h, f"{name}.post")], 1)
        return z

    # -- decoders -----------------------------------------------------------------

    def resblocks(self, x, stage):
        total = None
        for j, (k, dils) in enumerate(zip(self.m["resblock_kernel_sizes"],
                                          self.m["resblock_dilation_sizes"])):
            y = x
            name = f"dec.resblocks.{stage * 3 + j}"
            for jj, d in enumerate(dils):
                t = self.conv(lrelu(y), f"{name}.convs1.{jj}", dilation=d,
                              padding=d * (k - 1) // 2, quant=True)
                t = self.conv(lrelu(t), f"{name}.convs2.{jj}",
                              padding=(k - 1) // 2, quant=True)
                y = y + t
            total = y if total is None else total + y
        return total / len(self.m["resblock_kernel_sizes"])

    def upsampling(self, z, rates, kernels):
        x = self.conv(z, "dec.conv_pre", padding=3, quant=True)
        for i, (u, k) in enumerate(zip(rates, kernels)):
            x = self.conv_t(lrelu(x), f"dec.ups.{i}", u, (k - u) // 2)
            x = self.resblocks(x, i)
        return lrelu(x)

    def hifigan(self, z):
        x = self.upsampling(z, self.m["upsample_rates"],
                            self.m["upsample_kernel_sizes"])
        return torch.tanh(self.conv(x, "dec.conv_post", padding=3))[0, 0]

    def mb_istft(self, z):
        x = self.upsampling(z, self.m["mb_upsample_rates"],
                            self.m["mb_upsample_kernel_sizes"])
        head = self.conv(x, "dec.conv_post", padding=3)[0]
        bands, n_fft = self.m["subbands"], self.m["istft_n_fft"]
        hop = self.m["istft_hop"]
        bins = n_fft // 2 + 1
        head = head.reshape(bands, 2, bins, -1)
        mag = torch.exp(head[:, 0].clamp(*LOG_MAG_RANGE))
        spec = torch.polar(mag, head[:, 1]).transpose(1, 2)  # [S, F, bins]
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1)  # [S, F, n_fft]
        window = torch.hann_window(n_fft, periodic=True, device=z.device)
        n = frames.shape[1]
        length = (n - 1) * hop + n_fft
        audio = torch.zeros(bands, length, device=z.device)
        wsum = torch.zeros(length, device=z.device)
        for j in range(n_fft):  # sample j of frame i lands at i * hop + j
            audio[:, j: j + n * hop: hop] += frames[:, :, j] * window[j]
            wsum[j: j + n * hop: hop] += window[j] ** 2
        audio = audio / wsum.clamp(min=1e-8)
        start = (n_fft - hop) // 2
        audio = audio[:, start: start + n * hop]  # [S, F * hop]
        taps = np.arange(PQMF_TAPS + 1) - PQMF_TAPS / 2
        proto = PQMF_CUTOFF * np.sinc(PQMF_CUTOFF * taps) * np.kaiser(
            PQMF_TAPS + 1, PQMF_BETA)
        k = np.arange(bands)[:, None]
        filters = 2 * proto * np.cos(
            (2 * k + 1) * np.pi / (2 * bands) * taps
            - (-1.0) ** k * np.pi / 4)
        syn = torch.tensor(filters, dtype=torch.float32, device=z.device)
        full = F.conv_transpose1d(audio[None], syn[:, None, :], stride=bands)
        full = F.pad(full[0, 0], (0, PQMF_TAPS))
        offset = PQMF_TAPS // 2
        return full[offset: offset + audio.shape[1] * bands] * bands

    def decode(self, m_p, logs_p, durations: typing.Sequence[int], seed: int,
               noise_scale: float, pad: int) -> np.ndarray:
        """The waveform of one utterance at the given integer durations:
        ``sum(durations) * hop`` float32 samples."""
        with torch.inference_mode(), _tf32(self.control):
            d = torch.tensor(list(durations), device=self.device)
            frames = max(1, int(d.sum()))
            total = frames + pad
            m = torch.repeat_interleave(m_p[0], d, dim=1)
            logs = torch.repeat_interleave(logs_p[0], d, dim=1)
            eps = nz.positions(seed, nz.PRIOR_STREAM, m.shape[1],
                               m.shape[0]).t().to(self.device)
            z = (m + eps * torch.exp(logs) * noise_scale)[None]
            z = F.pad(z, (0, total - z.shape[-1]))
            z = self.flow_reverse(z[..., :frames])
            z = F.pad(z, (0, total - frames))
            audio = self.mb_istft(z) if self.is_mb else self.hifigan(z)
            return audio[: frames * self.hop].float().cpu().numpy()
