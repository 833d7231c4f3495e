"""Operations and bytes of the work the inputs need, and the card's peaks.

Closed forms over a configuration's ``model`` settings, the same whatever
implements the work: multiply-adds of convolutions, transposed
convolutions and matrix products, counted as 2 FLOPs each, at each
utterance's own phoneme and frame counts (never a bucket's padding).
Elementwise work, norms, softmax and FFTs are not counted.  Two choices
of what the work is:

- relative attention needs each query against the ``2 * 4 + 1`` offsets
  of its window, for keys and for values (an implementation may compute
  a product over all ``2T - 1`` offsets);
- the pseudo-QMF synthesis needs ``taps + 1`` products per output
  sample (a zero-stuffed convolution computes ``subbands`` times more).

``stage_work`` is the fused HiFi-GAN stage kernel's operations and bytes
at the shape of one launch, from ``chip_smoke.py``'s ``stage_work``: the
upsampler, every resblock convolution and, on the last stage,
``conv_post``; its input read once, its output written once, and its
weights.
"""

from __future__ import annotations

import math
import typing

# NVIDIA H100 SXM datasheet, dense, at 700 W: the bf16 tensor-core rate
# and the HBM3 bandwidth.  Shares are stated against these and refused on
# any other card (``peak_for``).
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12

REL_WINDOW = 4
SDP_FILTER = 192
SDP_BINS = 10
SDP_DDS_LAYERS = 3
SDP_KERNEL = 3
SDP_CONV_FLOWS = 3
FLOW_COUPLINGS = 4
WN_LAYERS = 4
WN_KERNEL = 5
PQMF_TAPS = 62


def peak_for(device_name: str) -> float:
    """The bf16 peak of ``device_name``; only the H100 SXM is known (the
    PCIe and NVL parts have other rates)."""
    if "H100" not in device_name or "PCIe" in device_name \
            or "NVL" in device_name:
        raise RuntimeError(f"no published bf16 peak for {device_name!r}")
    return H100_BF16_FLOPS


def conv(t_out: int, cin: int, cout: int, k: int, groups: int = 1) -> int:
    return 2 * t_out * (cin // groups) * cout * k


def encoder(m, t: int) -> int:
    h, f, k = m["hidden_channels"], m["filter_channels"], m["kernel_size"]
    window = 2 * REL_WINDOW + 1
    layer = (4 * conv(t, h, h, 1)            # q, k, v, o
             + 2 * 2 * t * t * h             # q.k and p.v over all heads
             + 2 * 2 * t * window * h        # relative keys and values
             + conv(t, h, f, k) + conv(t, f, h, k))
    return m["n_layers"] * layer + conv(t, h, 2 * m["inter_channels"], 1)


def _dds(t: int, c: int) -> int:
    return SDP_DDS_LAYERS * (conv(t, c, c, SDP_KERNEL, groups=c)
                             + conv(t, c, c, 1))


def duration(m, t: int) -> int:
    c = SDP_FILTER
    cond = conv(t, m["hidden_channels"], c, 1) + _dds(t, c) + conv(t, c, c, 1)
    flows = SDP_CONV_FLOWS * (conv(t, 1, c, 1) + _dds(t, c)
                              + conv(t, c, 3 * SDP_BINS - 1, 1))
    return cond + flows


def flow(m, f: int) -> int:
    h, half = m["hidden_channels"], m["inter_channels"] // 2
    wn = sum(conv(f, h, 2 * h, WN_KERNEL)
             + conv(f, h, 2 * h if j < WN_LAYERS - 1 else h, 1)
             for j in range(WN_LAYERS))
    return FLOW_COUPLINGS * (conv(f, half, h, 1) + wn + conv(f, h, half, 1))


def _resblocks(m, t: int, c: int) -> int:
    return sum(2 * len(d) * conv(t, c, c, k) for k, d in
               zip(m["resblock_kernel_sizes"], m["resblock_dilation_sizes"]))


def _stages(m, f: int, rates, kernels) -> typing.Tuple[int, int, int]:
    """(FLOPs of conv_pre and every stage, last length, last channels)."""
    ch = m["upsample_initial_channel"]
    total = conv(f, m["inter_channels"], ch, 7)
    t = f
    for u, k in zip(rates, kernels):
        total += conv(t, ch, ch // 2, k)  # each input sample, K outputs
        t, ch = t * u, ch // 2
        total += _resblocks(m, t, ch)
    return total, t, ch


def decoder(m, f: int) -> int:
    if m.get("decoder_type", "hifigan") == "mb-istft":
        total, t, ch = _stages(m, f, m["mb_upsample_rates"],
                               m["mb_upsample_kernel_sizes"])
        bands, n_fft = m["subbands"], m["istft_n_fft"]
        bins = n_fft // 2 + 1
        total += conv(t, ch, bands * 2 * bins, 7)
        total += 2 * bands * t * 2 * bins * n_fft  # inverse DFT per frame
        samples = t * m["istft_hop"] * bands
        return total + 2 * (PQMF_TAPS + 1) * samples
    total, t, ch = _stages(m, f, m["upsample_rates"],
                           m["upsample_kernel_sizes"])
    return total + conv(t, ch, 1, 7)


def utterance(m, phonemes: int, frames: int) -> typing.Dict[str, int]:
    parts = {
        "encoder": encoder(m, phonemes),
        "duration": duration(m, phonemes),
        "flow": flow(m, frames),
        "decoder": decoder(m, frames),
    }
    parts["total"] = sum(parts.values())
    return parts


def hop(m) -> int:
    if m.get("decoder_type", "hifigan") == "mb-istft":
        return (math.prod(m["mb_upsample_rates"]) * m["istft_hop"]
                * m["subbands"])
    return math.prod(m["upsample_rates"])


def stage_of_channels(m, channels: int) -> int:
    """The HiFi-GAN stage whose output has ``channels`` channels."""
    ch = m["upsample_initial_channel"]
    for i in range(len(m["upsample_rates"])):
        ch //= 2
        if ch == channels:
            return i
    raise ValueError(f"no stage of {channels} channels")


def stage_work(m, stage: int, batch: int, frames: int
               ) -> typing.Tuple[int, int]:
    """(FLOPs, bytes) of one fused-stage launch on ``batch`` rows of a
    ``frames``-frame decode, in bf16 (the last stage writes float32
    audio)."""
    rates, kernels = m["upsample_rates"], m["upsample_kernel_sizes"]
    c_in = m["upsample_initial_channel"] >> stage
    c = c_in // 2
    t_in = frames * math.prod(rates[:stage])
    t_out = t_in * rates[stage]
    last = stage == len(rates) - 1
    flops = batch * (conv(t_in, c_in, c, kernels[stage])
                     + _resblocks(m, t_out, c)
                     + (conv(t_out, c, 1, 7) if last else 0))
    weights = (c_in * c * kernels[stage]
               + sum(2 * len(d) * c * c * k for k, d in zip(
                   m["resblock_kernel_sizes"], m["resblock_dilation_sizes"]))
               + (c * 7 if last else 0))
    biases = c + sum(2 * len(d) * c for d in m["resblock_dilation_sizes"])
    nbytes = (batch * c_in * t_in * 2
              + batch * t_out * (4 if last else 2 * c)
              + weights * 2 + biases * 4)
    return flops, nbytes
