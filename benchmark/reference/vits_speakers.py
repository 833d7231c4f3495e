"""Multi-speaker VITS inference (VITS ``configs/vctk_base.json``), one
utterance and one speaker at a time, in plain PyTorch.

:class:`VitsSpeakers` is :class:`.vits.Vits` with VITS's global
conditioning: ``g = emb_g[sid][:, :, None]``, ``[1, gin, 1]``, and a
1x1 convolution of ``g`` added to the output of three convolutions
(VITS ``models.py`` / ``modules.py``):

- the duration predictor's ``pre``: ``x = pre(x) + cond(g)`` before its
  DDS convolutions;
- each of the flow's WaveNet ``in_layers[j]``: the slice ``[2 h j,
  2 h (j + 1))`` of ``cond_layer(g)`` is added before ``tanh(a[:h]) *
  sigmoid(a[h:])``;
- the decoder's ``conv_pre``: ``x = conv_pre(z) + cond(g)``.

The text encoder takes no ``g``; the posterior encoder's is for training
alone.  ``precision="control"`` keeps its meaning: the decoder's
``cond`` is a decoder convolution (float8 e4m3), the rest run under
TF32.

:func:`layout_speakers` is the voice file of such a model: the
single-speaker :func:`.params.layout` plus the speaker leaves at VITS's
initializers (``nn.Embedding``'s normal of std 1, PyTorch's default for
the three ``cond`` convolutions, weight norm on the flows' ``cond_layer``
with its gain at the norm of its direction).

It imports nothing of the program, nothing of the JAX package and no JAX.
"""

from __future__ import annotations

import typing

import torch

from .params import (
    FLOW_COUPLINGS, SDP_FILTER, WN_LAYERS, Leaf, _conv, layout,
)
from .vits import Vits


def layout_speakers(m: typing.Mapping[str, typing.Any]) -> typing.List[Leaf]:
    """Every leaf of a multi-speaker voice file: the single-speaker
    model's, then the speaker leaves."""
    gin = m["gin_channels"]
    leaves = layout(dict(m, n_speakers=1, gin_channels=0))
    leaves.append(Leaf("emb_g.weight", (m["n_speakers"], gin), "normal",
                       1.0))
    _conv(leaves, "dp.cond", gin, SDP_FILTER, 1)
    for c in range(FLOW_COUPLINGS):
        _conv(leaves, f"flow.flows.{2 * c}.enc.cond_layer", gin,
              2 * m["hidden_channels"] * WN_LAYERS, 1, wn=True)
    _conv(leaves, "dec.cond", gin, m["upsample_initial_channel"], 1)
    return leaves


class VitsSpeakers(Vits):
    """:class:`Vits` for one speaker: :meth:`with_speaker` binds the
    speaker id that :meth:`durations` and :meth:`decode` run for."""

    def __init__(self, model: typing.Mapping[str, typing.Any],
                 params: typing.Mapping[str, torch.Tensor],
                 device: torch.device, precision: str = "float32",
                 speaker: int = 0):
        super().__init__(model, params, device, precision)
        self.precision = precision
        self.speaker = int(speaker)
        # conditioned convolution -> the cond convolution added to it
        self.conditioned = {"dp.pre": "dp.cond", "dec.conv_pre": "dec.cond"}
        for c in range(FLOW_COUPLINGS):
            wn = f"flow.flows.{2 * c}.enc"
            for j in range(WN_LAYERS):
                self.conditioned[f"{wn}.in_layers.{j}"] = f"{wn}.cond_layer"

    def with_speaker(self, speaker: int) -> "VitsSpeakers":
        """The same weights, for ``speaker``."""
        return VitsSpeakers(self.m, self.p, self.device, self.precision,
                            speaker)

    def g(self) -> torch.Tensor:
        return self.p["emb_g.weight"][self.speaker][None, :, None]

    def conv(self, x, name, *, padding=0, dilation=1, groups=1, quant=False):
        y = super().conv(x, name, padding=padding, dilation=dilation,
                         groups=groups, quant=quant)
        cond = self.conditioned.get(name)
        if cond is None:
            return y
        term = super().conv(self.g(), cond, quant=quant)
        if cond.endswith("cond_layer"):
            j, h = int(name.rsplit(".", 1)[1]), self.m["hidden_channels"]
            term = term[:, 2 * h * j: 2 * h * (j + 1)]
        return y + term
