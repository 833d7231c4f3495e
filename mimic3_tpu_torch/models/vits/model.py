"""Top-level VITS model: parameter init and the two-stage synthesis path.

Counterpart of ``mimic3_tpu/models/vits/model.py``:

1. :meth:`VitsModel.infer_durations` — encoder + duration predictor ->
   per-phoneme frame counts (its output is the one host sync),
2. :meth:`VitsModel.decode_frames` — encoder + prior sample + flow
   inverse + HiFi-GAN over a frame bucket (or a window of it),
3. :meth:`VitsModel.stream_start` — both at once for streaming: the
   encoder once, durations, and the first decode window.

Public shapes match the JAX package: ids ``[B, T]``, durations ``[B, T]``
int32, audio ``[B, samples]`` float32; internally ``[B, C, T]``, which is
also the layout of the encoder statistics ``(m_p, logs_p)`` that
``stream_start`` returns and ``decode_frames(enc_stats=...)`` takes.

Noise keeps the reference's contract with its own generator: a value
depends only on (seed, frame or phoneme position, channel) — never on
the batch slot, the bucket or the frame offset (:func:`indexed_noise`).
JAX's threefry bits cannot be reproduced, so parity tests inject the
same numpy noise into both packages (``dur_noise=`` / ``prior_noise=``).
"""

from __future__ import annotations

import math
import typing
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ... import tracing
from ...config import ModelConfig
from ...parallel import tensor as tp
from . import duration as dur
from . import encoder as enc
from . import flow as flw
from . import hifigan as hfg
from . import mbistft as mbi
from .layers import Params, sequence_mask


@dataclass(frozen=True)
class VitsHyperparams:
    """Static hyperparameters derived from a voice's ModelConfig."""

    num_symbols: int
    n_speakers: int
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    resblock: str = "1"
    resblock_kernel_sizes: typing.Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: typing.Tuple[typing.Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    upsample_rates: typing.Tuple[int, ...] = (8, 8, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: typing.Tuple[int, ...] = (16, 16, 4, 4)
    gin_channels: int = 0
    use_sdp: bool = True
    decoder_type: str = "hifigan"
    subbands: int = 4
    istft_n_fft: int = 16
    istft_hop: int = 4
    mb_upsample_rates: typing.Tuple[int, ...] = (4, 4)
    mb_upsample_kernel_sizes: typing.Tuple[int, ...] = (16, 16)

    @property
    def hop_length(self) -> int:
        if self.decoder_type == "mb-istft":
            return mbi.mb_istft_hop(
                self.mb_upsample_rates, self.istft_hop, self.subbands
            )
        return math.prod(self.upsample_rates)

    @staticmethod
    def from_config(config: ModelConfig) -> "VitsHyperparams":
        return VitsHyperparams(
            decoder_type=getattr(config, "decoder_type", "hifigan"),
            subbands=getattr(config, "subbands", 4),
            istft_n_fft=getattr(config, "istft_n_fft", 16),
            istft_hop=getattr(config, "istft_hop", 4),
            mb_upsample_rates=tuple(
                getattr(config, "mb_upsample_rates", (4, 4))
            ),
            mb_upsample_kernel_sizes=tuple(
                getattr(config, "mb_upsample_kernel_sizes", (16, 16))
            ),
            num_symbols=config.num_symbols,
            n_speakers=config.n_speakers,
            inter_channels=config.inter_channels,
            hidden_channels=config.hidden_channels,
            filter_channels=config.filter_channels,
            n_heads=config.n_heads,
            n_layers=config.n_layers,
            kernel_size=config.kernel_size,
            resblock=config.resblock,
            resblock_kernel_sizes=tuple(config.resblock_kernel_sizes),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in config.resblock_dilation_sizes
            ),
            upsample_rates=tuple(config.upsample_rates),
            upsample_initial_channel=config.upsample_initial_channel,
            upsample_kernel_sizes=tuple(config.upsample_kernel_sizes),
            gin_channels=config.gin_channels,
            use_sdp=config.use_sdp,
        )


# ---------------------------------------------------------------------------
# Noise
# ---------------------------------------------------------------------------

# a scalar factor: a float, or a 0-d float32 tensor on the device
Scale = typing.Union[float, torch.Tensor]

NOISE_CHUNK = 256  # positions per generator
PRIOR_NOISE_STREAM = 1
DURATION_NOISE_STREAM = 2
_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def mix_seed(*values: int) -> int:
    """Hash integers into one 63-bit generator seed."""
    h = 0
    for v in values:
        h = _splitmix64(h ^ (int(v) & _MASK64))
    return h >> 1


def indexed_noise(
    seed: int, stream: int, start: int, count: int, channels: int
) -> torch.Tensor:
    """Standard normal noise ``[count, channels]`` for positions
    ``[start, start + count)``.

    Positions are cut into fixed chunks of :data:`NOISE_CHUNK`; each chunk
    comes from a CPU ``torch.Generator`` seeded by (seed, stream, chunk),
    so a value depends only on (seed, stream, position, channel) and is
    the same on every device.
    """
    with tracing.span("model.noise", count=count, channels=channels):
        first = start // NOISE_CHUNK
        last = (start + max(count, 1) - 1) // NOISE_CHUNK
        gen = torch.Generator()
        chunks = []
        for chunk in range(first, last + 1):
            gen.manual_seed(mix_seed(seed, stream, chunk))
            chunks.append(torch.randn(NOISE_CHUNK, channels, generator=gen))
        offset = start - first * NOISE_CHUNK
        return torch.cat(chunks)[offset : offset + count]


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``.  To a card the copy is staged in
    pinned memory and does not block the host: a plain ``.to("cuda")``
    of pageable memory waits for the stream, which would stall the host
    behind the work already queued (the speculative decode's)."""
    if device.type != "cuda" or t.device.type == "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# Initialization (same key names and shapes as init_vits_params)
# ---------------------------------------------------------------------------


class _Init:
    """Seeded initializers producing tensors in the JAX package's layout
    (conv ``[K, Cin/g, Cout]``, weight norm as ``weight_v``/``weight_g``)."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(seed)

    def uniform(self, shape, bound: float) -> torch.Tensor:
        return (torch.rand(shape, generator=self.gen) * 2 - 1) * bound

    def normal(self, shape, std: float) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen) * std

    def _weight(self, weight: torch.Tensor, weight_norm: bool) -> Params:
        if not weight_norm:
            return {"weight": weight}
        # the norm over every axis but the output channel (the last)
        dims = tuple(range(weight.dim() - 1))
        norm = weight.square().sum(dim=dims, keepdim=True).sqrt()
        return {"weight_v": weight, "weight_g": norm}

    def conv(
        self,
        cin: int,
        cout: int,
        k: int,
        *,
        groups: int = 1,
        bias: bool = True,
        weight_norm: bool = False,
        init: str = "torch",
    ) -> Params:
        shape = (k, cin // groups, cout)
        bound = 1.0 / math.sqrt((cin // groups) * k)
        if init == "zeros":
            weight = torch.zeros(shape)
        elif init == "normal":
            weight = self.normal(shape, 0.01)
        else:
            weight = self.uniform(shape, bound)
        p = self._weight(weight, weight_norm)
        if bias:
            p["bias"] = (
                torch.zeros(cout)
                if init == "zeros"
                else self.uniform((cout,), bound)
            )
        return p

    def conv_transpose(self, cin: int, cout: int, k: int) -> Params:
        p = self._weight(self.normal((k, cin, cout), 0.01), True)
        p["bias"] = self.uniform((cout,), 1.0 / math.sqrt(cin * k))
        return p

    def conv2d(self, cin: int, cout: int, kh: int, kw: int) -> Params:
        """Weight-normed 2-D conv, HWIO ``[kh, kw, Cin, Cout]``."""
        bound = 1.0 / math.sqrt(cin * kh * kw)
        p = self._weight(self.uniform((kh, kw, cin, cout), bound), True)
        p["bias"] = self.uniform((cout,), bound)
        return p

    @staticmethod
    def layer_norm(channels: int) -> Params:
        return {"gamma": torch.ones(channels), "beta": torch.zeros(channels)}


def _init_dds_conv(ini: _Init, channels: int, n_layers: int) -> Params:
    k = dur.SDP_KERNEL
    return {
        "convs_sep": {
            str(i): ini.conv(channels, channels, k, groups=channels)
            for i in range(n_layers)
        },
        "convs_1x1": {
            str(i): ini.conv(channels, channels, 1) for i in range(n_layers)
        },
        "norms_1": {
            str(i): ini.layer_norm(channels) for i in range(n_layers)
        },
        "norms_2": {
            str(i): ini.layer_norm(channels) for i in range(n_layers)
        },
    }


def _init_sdp_flows(ini: _Init, filter_channels: int) -> Params:
    flows: Params = {"0": {"m": torch.zeros(2), "logs": torch.zeros(2)}}
    for i in range(dur.SDP_N_FLOWS):
        flows[str(2 * i + 1)] = {
            "pre": ini.conv(1, filter_channels, 1),
            "convs": _init_dds_conv(
                ini, filter_channels, dur.SDP_DDS_LAYERS
            ),
            "proj": ini.conv(
                filter_channels, dur.SDP_NUM_BINS * 3 - 1, 1, init="zeros"
            ),
        }
    return flows


def _init_sdp(ini: _Init, hp: VitsHyperparams) -> Params:
    fc = 192  # VITS: StochasticDurationPredictor(hidden, 192, 3, 0.5, 4)
    p: Params = {
        "pre": ini.conv(hp.hidden_channels, fc, 1),
        "proj": ini.conv(fc, fc, 1),
        "convs": _init_dds_conv(ini, fc, dur.SDP_DDS_LAYERS),
        "flows": _init_sdp_flows(ini, fc),
        "post_pre": ini.conv(1, fc, 1),
        "post_proj": ini.conv(fc, fc, 1),
        "post_convs": _init_dds_conv(ini, fc, dur.SDP_DDS_LAYERS),
        "post_flows": _init_sdp_flows(ini, fc),
    }
    if hp.gin_channels > 0:
        p["cond"] = ini.conv(hp.gin_channels, fc, 1)
    return p


def _init_dp(ini: _Init, hp: VitsHyperparams) -> Params:
    fc = 256  # VITS: DurationPredictor(hidden, 256, 3, 0.5)
    p: Params = {
        "conv_1": ini.conv(hp.hidden_channels, fc, dur.SDP_KERNEL),
        "norm_1": ini.layer_norm(fc),
        "conv_2": ini.conv(fc, fc, dur.SDP_KERNEL),
        "norm_2": ini.layer_norm(fc),
        "proj": ini.conv(fc, 1, 1),
    }
    if hp.gin_channels > 0:
        p["cond"] = ini.conv(hp.gin_channels, hp.hidden_channels, 1)
    return p


def _init_encoder(ini: _Init, hp: VitsHyperparams) -> Params:
    h = hp.hidden_channels
    head_dim = h // hp.n_heads
    rel_shape = (1, 2 * enc.WINDOW_SIZE + 1, head_dim)
    p: Params = {
        "emb": {"weight": ini.normal((hp.num_symbols, h), h**-0.5)},
        "attn_layers": {},
        "norm_layers_1": {},
        "ffn_layers": {},
        "norm_layers_2": {},
        "proj": ini.conv(h, 2 * hp.inter_channels, 1),
    }
    for i in range(hp.n_layers):
        si = str(i)
        p["attn_layers"][si] = {
            "conv_q": ini.conv(h, h, 1),
            "conv_k": ini.conv(h, h, 1),
            "conv_v": ini.conv(h, h, 1),
            "conv_o": ini.conv(h, h, 1),
            "emb_rel_k": ini.normal(rel_shape, head_dim**-0.5),
            "emb_rel_v": ini.normal(rel_shape, head_dim**-0.5),
        }
        p["norm_layers_1"][si] = ini.layer_norm(h)
        p["ffn_layers"][si] = {
            "conv_1": ini.conv(h, hp.filter_channels, hp.kernel_size),
            "conv_2": ini.conv(hp.filter_channels, h, hp.kernel_size),
        }
        p["norm_layers_2"][si] = ini.layer_norm(h)
    return p


def _init_wavenet(
    ini: _Init, hidden: int, kernel_size: int, n_layers: int, gin_channels: int
) -> Params:
    wn: Params = {"in_layers": {}, "res_skip_layers": {}}
    for j in range(n_layers):
        out_ch = 2 * hidden if j < n_layers - 1 else hidden
        wn["in_layers"][str(j)] = ini.conv(
            hidden, 2 * hidden, kernel_size, weight_norm=True
        )
        wn["res_skip_layers"][str(j)] = ini.conv(
            hidden, out_ch, 1, weight_norm=True
        )
    if gin_channels > 0:
        wn["cond_layer"] = ini.conv(
            gin_channels, 2 * hidden * n_layers, 1, weight_norm=True
        )
    return wn


def _init_flow(ini: _Init, hp: VitsHyperparams) -> Params:
    half = hp.inter_channels // 2
    h = hp.hidden_channels
    flows: Params = {}
    for i in range(flw.N_COUPLING):
        wn = _init_wavenet(
            ini, h, flw.WN_KERNEL, flw.WN_LAYERS, hp.gin_channels
        )
        flows[str(2 * i)] = {
            "pre": ini.conv(half, h, 1),
            "enc": wn,
            "post": ini.conv(h, half, 1, init="zeros"),
        }
    return {"flows": flows}


def _init_hifigan(ini: _Init, hp: VitsHyperparams) -> Params:
    ch = hp.upsample_initial_channel
    p: Params = {
        "conv_pre": ini.conv(hp.inter_channels, ch, 7),
        "ups": {},
        "resblocks": {},
    }
    n_kernels = len(hp.resblock_kernel_sizes)
    for i, k in enumerate(hp.upsample_kernel_sizes):
        out_ch = ch // 2
        p["ups"][str(i)] = ini.conv_transpose(ch, out_ch, k)
        for j, (rk, rd) in enumerate(
            zip(hp.resblock_kernel_sizes, hp.resblock_dilation_sizes)
        ):
            keys = ("convs1", "convs2") if hp.resblock == "1" else ("convs",)
            p["resblocks"][str(i * n_kernels + j)] = {
                key: {
                    str(jj): ini.conv(
                        out_ch, out_ch, rk, weight_norm=True, init="normal"
                    )
                    for jj in range(len(rd))
                }
                for key in keys
            }
        ch = out_ch
    p["conv_post"] = ini.conv(ch, 1, 7, bias=False)
    if hp.gin_channels > 0:
        p["cond"] = ini.conv(hp.gin_channels, hp.upsample_initial_channel, 1)
    return p


DECODER_TYPES = ("hifigan", "mb-istft")


def _check_decoder(hp: VitsHyperparams) -> None:
    if hp.decoder_type not in DECODER_TYPES:
        raise ValueError(
            f"unknown decoder_type {hp.decoder_type!r} (one of "
            f"{', '.join(DECODER_TYPES)})"
        )


def init_params(seed: int, config: ModelConfig) -> Params:
    """Random VITS parameters with the key names and shapes of
    ``mimic3_tpu.models.vits.init_vits_params`` (JAX layout, weight norm
    unfolded), drawn from a seeded ``torch.Generator``."""
    hp = VitsHyperparams.from_config(config)
    _check_decoder(hp)
    ini = _Init(seed)
    params: Params = {
        "enc_p": _init_encoder(ini, hp),
        "dp": _init_sdp(ini, hp) if hp.use_sdp else _init_dp(ini, hp),
        "flow": _init_flow(ini, hp),
        "dec": (
            mbi.init_mb_istft(
                ini,
                hp.inter_channels,
                initial_channel=hp.upsample_initial_channel,
                subbands=hp.subbands,
                istft_n_fft=hp.istft_n_fft,
                upsample_rates=hp.mb_upsample_rates,
                upsample_kernel_sizes=hp.mb_upsample_kernel_sizes,
                resblock_kernel_sizes=hp.resblock_kernel_sizes,
                resblock_dilation_sizes=hp.resblock_dilation_sizes,
                gin_channels=hp.gin_channels,
            )
            if hp.decoder_type == "mb-istft"
            else _init_hifigan(ini, hp)
        ),
    }
    if hp.n_speakers > 1:
        params["emb_g"] = {
            "weight": ini.normal(
                (hp.n_speakers, hp.gin_channels), hp.gin_channels**-0.5
            )
        }
    return params


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------


def expand_by_durations(
    values: torch.Tensor,
    durations: torch.Tensor,
    num_frames: int,
    frame_offset: int = 0,
) -> torch.Tensor:
    """Expand text-aligned values [B, C, T] to frames [B, C, F].

    Frame ``f`` takes the value of the phoneme whose cumulative-duration
    interval contains it; past-the-end frames clamp to the last phoneme.
    """
    b, c, t = values.shape
    cum = torch.cumsum(durations.long(), dim=1)
    frames = frame_offset + torch.arange(num_frames, device=cum.device)
    idx = torch.searchsorted(
        cum, frames.expand(b, num_frames).contiguous(), right=True
    ).clamp(max=t - 1)
    return torch.gather(values, 2, idx[:, None, :].expand(b, c, num_frames))


class VitsModel:
    """Functional VITS model bound to a voice's hyperparameters."""

    def __init__(
        self,
        config: ModelConfig,
        decoder_dtype: torch.dtype = torch.bfloat16,
        stage_max_channels: int = 0,
    ):
        self.hp = VitsHyperparams.from_config(config)
        _check_decoder(self.hp)
        self.decoder_dtype = decoder_dtype
        self.stage_max_channels = stage_max_channels

    def _decoder_kwargs(self) -> typing.Dict[str, typing.Any]:
        hp = self.hp
        return dict(
            resblock_kernel_sizes=hp.resblock_kernel_sizes,
            resblock_dilation_sizes=hp.resblock_dilation_sizes,
            upsample_rates=hp.upsample_rates,
            upsample_kernel_sizes=hp.upsample_kernel_sizes,
        )

    def pack_decoder(
        self, dec_params: Params, device: torch.device
    ) -> typing.Dict[int, "hfg.StageWeights"]:
        """Kernel weight packs for the fused decoder stages (once per
        voice; empty when no stage runs fused, as always for MB-iSTFT)."""
        if self.hp.decoder_type == "mb-istft":
            return {}
        stages = hfg.fused_stages(
            dec_params,
            resblock_type=self.hp.resblock,
            stage_max_channels=self.stage_max_channels,
            **self._decoder_kwargs(),
        )
        if any(tp.is_split(dec_params["ups"][str(i)]) for i in stages):
            raise ValueError(
                "the fused stage takes whole weights: a tp-split decoder "
                "runs with the stage gate at 0"
            )
        return hfg.pack_stages(
            dec_params, stages, device=device, dtype=self.decoder_dtype,
            **self._decoder_kwargs()
        )

    def encode(self, params: Params, ids: torch.Tensor, x_mask: torch.Tensor):
        return enc.text_encoder(
            params["enc_p"],
            ids,
            x_mask,
            n_layers=self.hp.n_layers,
            n_heads=self.hp.n_heads,
            kernel_size=self.hp.kernel_size,
        )

    @staticmethod
    def speaker_embedding(
        params: Params, sid: typing.Optional[torch.Tensor]
    ) -> typing.Optional[torch.Tensor]:
        if sid is None or "emb_g" not in params:
            return None
        return F.embedding(sid.long(), params["emb_g"]["weight"])[:, :, None]

    # -- stage 1: durations ----------------------------------------------------

    def infer_durations(
        self,
        params: Params,
        ids: torch.Tensor,
        lengths: torch.Tensor,
        seed: int,
        length_scale: Scale,
        noise_w: Scale,
        sid: typing.Optional[torch.Tensor] = None,
        dur_noise: typing.Optional[torch.Tensor] = None,
        g: typing.Optional[torch.Tensor] = None,
    ) -> typing.Tuple[torch.Tensor, torch.Tensor]:
        """Returns (frame counts per phoneme int32 [B, T], totals [B]).

        ``dur_noise`` [B, T, 2] overrides the position-indexed SDP noise.
        ``g`` is the speakers' embedding (:meth:`speaker_embedding`),
        gathered by the caller; without it ``sid``'s is gathered here.
        ``length_scale`` and ``noise_w`` may be 0-d float32 tensors on
        the device (a CUDA graph's inputs, read when it replays): a
        float32 product with one equals the product with the float.
        """
        durations, totals, _ = self._durations(
            params, ids, lengths, seed, length_scale, noise_w, sid, dur_noise,
            g,
        )
        return durations, totals

    @staticmethod
    def duration_noise(seed: int, t: int) -> torch.Tensor:
        """The SDP's noise ``[t, 2]`` on the host, position-indexed
        (:func:`indexed_noise`) and the same for every row."""
        return indexed_noise(seed, DURATION_NOISE_STREAM, 0, t, 2)

    def _durations(
        self,
        params: Params,
        ids: torch.Tensor,
        lengths: torch.Tensor,
        seed: int,
        length_scale: Scale,
        noise_w: Scale,
        sid: typing.Optional[torch.Tensor],
        dur_noise: typing.Optional[torch.Tensor] = None,
        g: typing.Optional[torch.Tensor] = None,
    ) -> typing.Tuple[
        torch.Tensor, torch.Tensor, typing.Tuple[torch.Tensor, torch.Tensor]
    ]:
        """Durations, totals and the encoder's (m_p, logs_p)."""
        b, t = ids.shape
        x_mask = sequence_mask(lengths, t)
        if g is None:
            g = self.speaker_embedding(params, sid)
        x, m_p, logs_p = self.encode(params, ids, x_mask)
        if self.hp.use_sdp:
            if dur_noise is None:
                noise = upload(
                    self.duration_noise(seed, t), x.device
                ).t()[None].expand(b, 2, t)
            else:
                noise = upload(dur_noise, x.device).transpose(1, 2)
            logw = dur.stochastic_duration_predictor_infer(
                params["dp"], x, x_mask, noise, noise_w, g=g
            )
        else:
            logw = dur.duration_predictor(params["dp"], x, x_mask, g=g)
        w = torch.exp(logw) * x_mask * length_scale
        w_ceil = torch.ceil(w)[:, 0].to(torch.int32)
        totals = torch.clamp(w_ceil.sum(dim=1), min=1)
        return w_ceil, totals, (m_p, logs_p)

    def stream_start(
        self,
        params: Params,
        ids: torch.Tensor,
        lengths: torch.Tensor,
        seed: int,
        length_scale: float,
        noise_w: float,
        noise_scale: float,
        num_frames: int,
        sid: typing.Optional[torch.Tensor] = None,
        stage_weights: typing.Optional[
            typing.Mapping[int, "hfg.StageWeights"]
        ] = None,
    ) -> typing.Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor
    ]:
        """First window of (batched) streaming, with the encoder run once.

        Returns ``(durations [B, T], totals [B], m_p, logs_p, audio0)``:
        the durations with the math of :meth:`infer_durations`, the
        encoder's prior statistics, and the first ``num_frames`` window
        decoded from them.  Continuation windows pass the statistics back
        to :meth:`decode_frames` (``enc_stats=``, same ``seed``); they
        meet the first window seam-exactly because the prior noise is
        frame-indexed and batch-invariant (:func:`indexed_noise`).
        """
        durations, totals, (m_p, logs_p) = self._durations(
            params, ids, lengths, seed, length_scale, noise_w, sid
        )
        audio0, _ = self.decode_frames(
            params, ids, lengths, durations, num_frames, seed, noise_scale,
            sid=sid, enc_stats=(m_p, logs_p), stage_weights=stage_weights,
        )
        return durations, totals, m_p, logs_p, audio0

    # -- stage 2: decode -------------------------------------------------------

    def decode_frames(
        self,
        params: Params,
        ids: torch.Tensor,
        lengths: torch.Tensor,
        durations: torch.Tensor,
        num_frames: int,
        seed: int,
        noise_scale: float,
        sid: typing.Optional[torch.Tensor] = None,
        prior_noise: typing.Optional[torch.Tensor] = None,
        frame_offset: int = 0,
        stage_weights: typing.Optional[
            typing.Mapping[int, "hfg.StageWeights"]
        ] = None,
        enc_stats: typing.Optional[
            typing.Tuple[torch.Tensor, torch.Tensor]
        ] = None,
        g: typing.Optional[torch.Tensor] = None,
    ) -> typing.Tuple[torch.Tensor, torch.Tensor]:
        """Decode to audio given per-phoneme frame counts.

        Returns (audio [B, num_frames*hop] float32, sample lengths [B]).
        ``frame_offset`` decodes the window ``[offset, offset +
        num_frames)`` of the utterance (chunked decode).
        ``prior_noise`` [B, F, inter] overrides the frame-indexed noise.
        ``enc_stats`` = precomputed ``(m_p, logs_p)`` skips the encoder.
        ``g`` = the speakers' embedding gathered by the caller.
        """
        x_mask = sequence_mask(lengths, ids.shape[1])
        if g is None:
            g = self.speaker_embedding(params, sid)
        if enc_stats is not None:
            m_p, logs_p = enc_stats
        else:
            _, m_p, logs_p = self.encode(params, ids, x_mask)

        durations = durations * x_mask[:, 0].to(durations.dtype)
        y_lengths = torch.clamp(durations.sum(dim=1), min=1)
        y_mask = sequence_mask(
            torch.clamp(y_lengths - frame_offset, min=0), num_frames
        )
        m_p_f = expand_by_durations(m_p, durations, num_frames, frame_offset)
        logs_p_f = expand_by_durations(
            logs_p, durations, num_frames, frame_offset
        )
        if prior_noise is None:
            noise = upload(
                indexed_noise(
                    seed, PRIOR_NOISE_STREAM, frame_offset, num_frames,
                    m_p_f.shape[1],
                ),
                m_p_f.device,
            ).t()[None]
        else:
            noise = upload(prior_noise, m_p_f.device).transpose(1, 2)
        z_p = (m_p_f + noise * torch.exp(logs_p_f) * noise_scale) * y_mask
        z = flw.residual_coupling_block_reverse(
            params["flow"], z_p, y_mask, g=g
        )
        audio = self.decode_waveform(
            params["dec"], z * y_mask, g=g, stage_weights=stage_weights
        )
        return audio, y_lengths * self.hp.hop_length

    def decode_waveform(
        self,
        dec_params: Params,
        z: torch.Tensor,
        g: typing.Optional[torch.Tensor] = None,
        stage_weights: typing.Optional[
            typing.Mapping[int, "hfg.StageWeights"]
        ] = None,
    ) -> torch.Tensor:
        """Latent frames [B, inter, F] -> waveform [B, F*hop] via the
        configured decoder family."""
        hp = self.hp
        if hp.decoder_type == "mb-istft":
            return mbi.mb_istft_generator(
                dec_params,
                z,
                g=g,
                subbands=hp.subbands,
                istft_n_fft=hp.istft_n_fft,
                istft_hop=hp.istft_hop,
                resblock_kernel_sizes=hp.resblock_kernel_sizes,
                resblock_dilation_sizes=hp.resblock_dilation_sizes,
                upsample_rates=hp.mb_upsample_rates,
                upsample_kernel_sizes=hp.mb_upsample_kernel_sizes,
                compute_dtype=self.decoder_dtype,
            )
        return hfg.hifigan_generator(
            dec_params,
            z,
            g=g,
            resblock_type=self.hp.resblock,
            compute_dtype=self.decoder_dtype,
            stage_max_channels=self.stage_max_channels,
            stage_weights=stage_weights,
            **self._decoder_kwargs(),
        )

    def infer(
        self,
        params: Params,
        ids: torch.Tensor,
        lengths: torch.Tensor,
        seed: int,
        noise_scale: float,
        length_scale: float,
        noise_w: float,
        max_frames: int,
        sid: typing.Optional[torch.Tensor] = None,
    ) -> typing.Tuple[torch.Tensor, torch.Tensor]:
        """Full pipeline with a fixed frame capacity (durations past
        ``max_frames`` are truncated)."""
        durations, _ = self.infer_durations(
            params, ids, lengths, seed, length_scale, noise_w, sid=sid
        )
        cum = torch.clamp(torch.cumsum(durations, dim=1), max=max_frames)
        durations = torch.cat([cum[:, :1], cum[:, 1:] - cum[:, :-1]], dim=1)
        return self.decode_frames(
            params, ids, lengths, durations, max_frames, seed, noise_scale,
            sid=sid,
        )
