"""VITS training: losses, generator forward, and the GAN train step.

Counterpart of ``mimic3_tpu/models/vits/train.py`` in ``[B, C, T]``
layout.  The objective is the VITS paper's:

- conditional VAE: KL between the flow-mapped posterior and the
  MAS-aligned text prior (weight ``c_kl``),
- mel-spectrogram L1 reconstruction on a random audio segment (weight
  ``c_mel``; ``segment_size``),
- stochastic-duration-predictor NLL,
- LSGAN adversarial + feature-matching losses against the multi-period /
  scale discriminators.

Parameters are nested dicts of leaf tensors with weight norm unfolded
(``weight_v``/``weight_g``), carried from the JAX layout by
``runtime/convert.py::to_torch_train_params``.  The whole step runs in
float32 with TF32 off, the reference's ``compute_dtype=f32`` and
``Precision.HIGHEST``.  The decoder keeps ``stage_max_channels=0`` as the
reference's ``make_train_step`` does (``train.py:356-360``), so training
launches no kernel: the kernels are launched through ``ctypes`` into a
preallocated output, which autograd could not see through.

Randomness: JAX's threefry bits cannot be reproduced, so every draw the
reference makes from its key (the posterior sample, the segment starts,
the duration posterior's ``e_q``) can be injected (:class:`TrainNoise`);
what is not injected comes from a ``torch.Generator``.

Data parallel (``train_step(..., shard=Shard(rank, world))``, the
reference's step under a dp mesh): each rank gets its rows of the global
batch and the step equals the single-device step on the global batch.
The losses normalized by a sum over the batch (KL by the valid frames,
the duration loss by the valid phonemes) take the global sums; each rank
draws the global batch's noise from the step's generator and keeps its
rows; each tree's gradients are summed over the ranks in one collective
before clipping, so every rank steps identically; the logged losses are
the global ones.  The mean losses (mel, adversarial, feature matching)
average over equal shards, which the trainer guarantees by rounding the
global batch to a multiple of the world size.
"""

from __future__ import annotations

import contextlib
import math
import typing
from dataclasses import dataclass, field

import torch

from ...config import TrainingConfig
from ...ops.stft import mel_spectrogram, spectrogram
from ...parallel import all_reduce_sum
from ...parallel.mesh import shard_rows
from ...runtime.session import full_f32_convolutions
from . import duration as dur
from . import flow as flw
from .discriminator import discriminate, init_discriminators
from .layers import Params, sequence_mask
from .mas import monotonic_alignment_search
from .model import VitsModel, _Init, init_params, mix_seed
from .posterior import init_posterior_encoder, posterior_encoder


@dataclass
class TrainBatch:
    """One training batch, padded to bucket shapes."""

    phoneme_ids: torch.Tensor  # int [B, T_text]
    text_lengths: torch.Tensor  # int [B]
    audio: torch.Tensor  # float32 [B, samples]
    spec_lengths: torch.Tensor  # int [B] (frames = samples // hop)
    speaker_ids: typing.Optional[torch.Tensor] = None  # int [B]

    def to(self, device: typing.Union[str, torch.device]) -> "TrainBatch":
        return TrainBatch(
            *(
                None if t is None else t.to(device)
                for t in (
                    self.phoneme_ids, self.text_lengths, self.audio,
                    self.spec_lengths, self.speaker_ids,
                )
            )
        )


@dataclass
class TrainNoise:
    """The draws of one generator forward, each optional: the posterior
    sample's noise [B, inter, T_spec], the duration posterior's ``e_q``
    [B, 2, T_text] and the segment starts [B] (frames)."""

    posterior: typing.Optional[torch.Tensor] = None
    duration: typing.Optional[torch.Tensor] = None
    starts: typing.Optional[torch.Tensor] = None


@dataclass(frozen=True)
class Shard:
    """This rank's part of a data-parallel step: the batch it gets is rows
    ``[rank * b, (rank + 1) * b)`` of a global batch of ``world * b``."""

    rank: int
    world: int

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch`` rows."""
        return shard_rows(self.rank, self.world, batch)


def init_training_params(
    seed: int, config: TrainingConfig
) -> typing.Tuple[Params, Params]:
    """(generator params incl. the posterior ``enc_q``, discriminator
    params) in the JAX package's layout, drawn from seeded generators."""
    params = init_params(seed, config.model)
    params["enc_q"] = init_posterior_encoder(
        _Init(mix_seed(seed, 1)),
        config.audio.filter_length // 2 + 1,
        config.model.inter_channels,
        config.model.hidden_channels,
        config.model.gin_channels,
        n_layers=16,
    )
    return params, init_discriminators(_Init(mix_seed(seed, 2)))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def kl_loss(
    z_p: torch.Tensor,
    logs_q: torch.Tensor,
    m_p: torch.Tensor,
    logs_p: torch.Tensor,
    y_mask: torch.Tensor,
    frames: typing.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KL(q(z|y) || p(z|text)) after the flow, per the VITS objective,
    normalized by the number of valid frames (not frames x channels):
    ``frames``, the global batch's count on a data-parallel shard, else
    ``sum(y_mask)``."""
    z_p = z_p.float()
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * (z_p - m_p).square() * torch.exp(-2.0 * logs_p)
    if frames is None:
        frames = torch.sum(y_mask)
    return torch.sum(kl * y_mask) / torch.clamp(frames, min=1.0)


def feature_matching_loss(
    fmaps_real: typing.Sequence[typing.Sequence[torch.Tensor]],
    fmaps_fake: typing.Sequence[typing.Sequence[torch.Tensor]],
) -> torch.Tensor:
    loss = 0.0
    for fr, ff in zip(fmaps_real, fmaps_fake):
        for r, f in zip(fr, ff):
            loss = loss + torch.mean(torch.abs(r.detach() - f))
    return 2.0 * loss


def generator_adv_loss(
    fake_logits: typing.Sequence[torch.Tensor],
) -> torch.Tensor:
    return sum(torch.mean((1.0 - lg).square()) for lg in fake_logits)


def discriminator_adv_loss(
    real_logits: typing.Sequence[torch.Tensor],
    fake_logits: typing.Sequence[torch.Tensor],
) -> torch.Tensor:
    loss = 0.0
    for r, f in zip(real_logits, fake_logits):
        loss = loss + torch.mean((1.0 - r).square()) + torch.mean(f.square())
    return loss


# ---------------------------------------------------------------------------
# Segment slicing
# ---------------------------------------------------------------------------


def random_segments(
    values: torch.Tensor,
    lengths: torch.Tensor,
    segment_frames: int,
    *,
    starts: typing.Optional[torch.Tensor] = None,
    generator: typing.Optional[torch.Generator] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Slice a [segment_frames] window per example.

    values: [B, C, T]; windows fit inside the valid region (short examples
    clamp to start 0).  ``starts`` [B] fixes the windows; without it they
    are drawn uniformly from ``generator``.  Returns (segments [B, C,
    segment_frames], starts [B]).
    """
    b, c, t = values.shape
    if starts is None:
        u = torch.rand(b, generator=generator, device=values.device)
        starts = segment_starts(u, lengths, segment_frames)
    starts = starts.to(values.device).long()
    idx = starts[:, None] + torch.arange(segment_frames, device=values.device)
    idx = torch.clamp(idx, max=t - 1)
    return torch.gather(values, 2, idx[:, None, :].expand(b, c, -1)), starts


def segment_starts(
    u: torch.Tensor, lengths: torch.Tensor, segment_frames: int
) -> torch.Tensor:
    """Window starts [B] from uniform draws ``u`` [B]: uniform over the
    starts that fit the valid frames (0 for short examples)."""
    max_start = torch.clamp(lengths - segment_frames, min=0)
    starts = (u * (max_start + 1).float()).long()
    return torch.minimum(starts, max_start)


def slice_audio_segments(
    audio: torch.Tensor, starts: torch.Tensor, segment_frames: int, hop: int
) -> torch.Tensor:
    idx = starts[:, None] * hop + torch.arange(
        segment_frames * hop, device=audio.device
    )
    return torch.gather(audio, 1, torch.clamp(idx, max=audio.shape[1] - 1))


# ---------------------------------------------------------------------------
# Generator training forward
# ---------------------------------------------------------------------------


def alignment_scores(
    z_p: torch.Tensor, m_p: torch.Tensor, logs_p: torch.Tensor
) -> torch.Tensor:
    """Log-likelihood of each frame of ``z_p`` [B, C, T_spec] under each
    text position's prior (m_p, logs_p [B, C, T_text]): [B, T_text,
    T_spec], the input of MAS."""
    s_p_sq_r = torch.exp(-2.0 * logs_p)  # [B, C, T_text]
    neg_1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, dim=1)
    neg_2 = torch.matmul(s_p_sq_r.transpose(1, 2), -0.5 * z_p.square())
    neg_3 = torch.matmul((m_p * s_p_sq_r).transpose(1, 2), z_p)
    neg_4 = torch.sum(-0.5 * m_p.square() * s_p_sq_r, dim=1)
    return neg_1[:, :, None] + neg_2 + neg_3 + neg_4[:, :, None]


def _no_mark(name: str) -> None:
    pass


def shard_draws(
    shard: Shard,
    noise: typing.Optional[TrainNoise],
    generator: typing.Optional[torch.Generator],
    *,
    batch: int,
    t_spec: int,
    t_text: int,
    inter: int,
    use_sdp: bool,
    spec_lengths: torch.Tensor,
    segment_frames: int,
) -> TrainNoise:
    """This rank's rows of the draws the one-device step makes for the
    whole global batch, in its order: the posterior sample, the duration
    posterior's ``e_q`` (with SDP), the segment starts' uniforms.  An
    injected field of ``noise`` is the global batch's; its rows are taken.
    ``batch`` is this rank's rows, ``spec_lengths`` theirs."""
    noise = noise or TrainNoise()
    n = batch * shard.world
    rows = shard.rows(n)
    device = spec_lengths.device
    posterior, duration = noise.posterior, noise.duration
    if posterior is None:
        posterior = torch.randn(
            n, inter, t_spec, generator=generator, device=device
        )
    if duration is None and use_sdp:
        duration = torch.randn(n, 2, t_text, generator=generator,
                               device=device)
    if noise.starts is None:
        u = torch.rand(n, generator=generator, device=device)[rows]
        starts = segment_starts(u, spec_lengths, segment_frames)
    else:
        starts = noise.starts[rows]
    return TrainNoise(
        posterior=posterior[rows].to(device),
        duration=None if duration is None else duration[rows].to(device),
        starts=starts.to(device),
    )


def generator_forward(
    model: VitsModel,
    config: TrainingConfig,
    params: Params,
    batch: TrainBatch,
    *,
    noise: typing.Optional[TrainNoise] = None,
    generator: typing.Optional[torch.Generator] = None,
    mark: typing.Callable[[str], None] = _no_mark,
    shard: typing.Optional[Shard] = None,
) -> typing.Dict[str, torch.Tensor]:
    """VITS training forward pass -> losses + fake/real audio segments.

    ``mark(name)`` is called where the part ``name`` of the work begins
    (``"mas"``, then ``"g_forward"`` again), for a caller timing them.
    On a data-parallel ``shard``, ``batch`` is the rank's rows and
    ``noise`` (if given) the global batch's draws; the duration and KL
    losses are normalized by the global batch's valid phonemes and frames.
    """
    audio_cfg = config.audio
    hop = audio_cfg.hop_length
    segment_frames = config.segment_size // hop

    ids = batch.phoneme_ids
    x_mask = sequence_mask(batch.text_lengths, ids.shape[1])
    g = None
    if batch.speaker_ids is not None and "emb_g" in params:
        g = model.speaker_embedding(params, batch.speaker_ids)

    # text prior
    x, m_p, logs_p = model.encode(params, ids, x_mask)

    # posterior from the linear spectrogram
    spec = spectrogram(
        batch.audio, audio_cfg.filter_length, hop, audio_cfg.win_length
    )
    y_mask = sequence_mask(batch.spec_lengths, spec.shape[2])
    if shard is not None:
        noise = shard_draws(
            shard, noise, generator, batch=ids.shape[0],
            t_spec=spec.shape[2], t_text=ids.shape[1],
            inter=config.model.inter_channels, use_sdp=model.hp.use_sdp,
            spec_lengths=batch.spec_lengths, segment_frames=segment_frames,
        )
    noise = noise or TrainNoise()
    phonemes = frames = None
    if shard is not None:
        phonemes, frames = all_reduce_sum(
            [torch.stack([torch.sum(x_mask), torch.sum(y_mask)])]
        )[0]
    z, m_q, logs_q = posterior_encoder(
        params["enc_q"], spec, y_mask, g=g, noise=noise.posterior,
        generator=generator,
    )

    # flow: posterior latent -> prior space
    z_p = flw.residual_coupling_block(params["flow"], z, y_mask, g=g)

    # alignment (no gradient)
    mark("mas")
    attn = monotonic_alignment_search(
        alignment_scores(z_p.detach(), m_p.detach(), logs_p.detach()),
        batch.text_lengths,
        batch.spec_lengths,
    )  # [B, T_text, T_spec]
    mark("g_forward")

    # durations + duration loss
    w = torch.sum(attn, dim=-1)[:, None] * x_mask  # [B, 1, T_text]
    if model.hp.use_sdp:
        nll = dur.stochastic_duration_predictor_nll(
            params["dp"], x, x_mask, w, g=g, noise=noise.duration,
            generator=generator,
        )
        loss_dur = torch.sum(nll)
    else:
        logw_hat = dur.duration_predictor(params["dp"], x, x_mask, g=g)
        logw = torch.log(w + 1e-6) * x_mask
        loss_dur = torch.sum((logw_hat - logw).square())
    if phonemes is None:
        phonemes = torch.sum(x_mask)
    loss_dur = loss_dur / torch.clamp(phonemes, min=1.0)

    # expand the prior to frames through the alignment
    m_p_f = torch.matmul(m_p, attn)  # [B, C, T_spec]
    logs_p_f = torch.matmul(logs_p, attn)
    loss_kl = kl_loss(z_p, logs_q, m_p_f, logs_p_f, y_mask, frames)

    # decode a random segment
    z_seg, starts = random_segments(
        z, batch.spec_lengths, segment_frames, starts=noise.starts,
        generator=generator,
    )
    y_hat = model.decode_waveform(params["dec"], z_seg, g=g)
    y_real = slice_audio_segments(batch.audio, starts, segment_frames, hop)

    mel_args = dict(
        sample_rate=audio_cfg.sample_rate,
        n_fft=audio_cfg.filter_length,
        hop_length=hop,
        win_length=audio_cfg.win_length,
        n_mels=audio_cfg.mel_channels,
        fmin=audio_cfg.mel_fmin,
        fmax=audio_cfg.mel_fmax,
    )
    loss_mel = torch.mean(
        torch.abs(
            mel_spectrogram(y_real, **mel_args)
            - mel_spectrogram(y_hat, **mel_args)
        )
    )
    return {
        "y_hat": y_hat,
        "y_real": y_real,
        "loss_mel": loss_mel,
        "loss_kl": loss_kl,
        "loss_dur": loss_dur,
        "attn": attn,
    }


# ---------------------------------------------------------------------------
# Train step (two optimizers, GAN)
# ---------------------------------------------------------------------------


def tree_leaves(tree: Params, prefix: str = "") -> typing.List[
    typing.Tuple[str, torch.Tensor]
]:
    """(dotted name, tensor) of every leaf, in the tree's order."""
    out = []
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.extend(tree_leaves(value, path))
        else:
            out.append((path, value))
    return out


@dataclass
class TrainState:
    params: Params
    disc_params: Params
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int = 0
    # (name, tensor) of every leaf of params / disc_params, the
    # optimizers' order
    g_leaves: typing.List[typing.Tuple[str, torch.Tensor]] = field(
        default_factory=list
    )
    d_leaves: typing.List[typing.Tuple[str, torch.Tensor]] = field(
        default_factory=list
    )


def make_optimizers(
    config: TrainingConfig, params: Params, disc_params: Params
) -> typing.Tuple[torch.optim.Optimizer, torch.optim.Optimizer]:
    """Adam over each tree's leaves with the config's betas and eps: the
    update of ``optax.adam`` (eps outside the square root).  The learning
    rate is set by the step (:func:`learning_rate`)."""

    def make(tree: Params) -> torch.optim.Optimizer:
        return torch.optim.Adam(
            [t for _, t in tree_leaves(tree)],
            lr=config.learning_rate,
            betas=tuple(config.betas),
            eps=config.eps,
        )

    return make(params), make(disc_params)


def learning_rate(
    config: TrainingConfig, count: int, steps_per_epoch: int
) -> float:
    """``lr_decay`` is a per-epoch factor, applied continuously per step;
    ``count`` is the number of updates before this one."""
    return config.learning_rate * config.lr_decay ** (count / steps_per_epoch)


def init_train_state(
    params: Params, disc_params: Params, config: TrainingConfig
) -> TrainState:
    """A state training the given torch-layout trees (their leaves are
    set to require grad) with fresh optimizers."""
    for tree in (params, disc_params):
        for _, t in tree_leaves(tree):
            t.requires_grad_(True)
    opt_g, opt_d = make_optimizers(config, params, disc_params)
    return TrainState(
        params=params,
        disc_params=disc_params,
        opt_g=opt_g,
        opt_d=opt_d,
        g_leaves=tree_leaves(params),
        d_leaves=tree_leaves(disc_params),
    )


def clip_by_global_norm(
    grads: typing.List[torch.Tensor], max_norm: float
) -> None:
    """In place, ``optax.clip_by_global_norm``'s rule: scale by ``max /
    norm`` only when the global norm exceeds ``max``."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads])
    )
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))


def _update(
    opt: torch.optim.Optimizer,
    leaves: typing.List[typing.Tuple[str, torch.Tensor]],
    grads: typing.Sequence[typing.Optional[torch.Tensor]],
    lr: float,
    grad_clip: typing.Optional[float],
    shard: typing.Optional[Shard] = None,
) -> None:
    """Adam on ``leaves`` with ``grads`` (None = unused: a zero gradient,
    which still moves a parameter by its moments as optax does), summed
    over the ranks first on a data-parallel ``shard``.  The gradients stay
    on each leaf's ``.grad``."""
    # each gradient in its parameter's strides (autograd may return other
    # strides, e.g. for a slice of a padded table), which keeps Adam's
    # multi-tensor kernels on their fast path
    grads = [
        torch.zeros_like(t) if g is None
        else g if g.stride() == t.stride()
        else torch.empty_like(t).copy_(g)
        for (_, t), g in zip(leaves, grads)
    ]
    if shard is not None:
        grads = all_reduce_sum(grads)
    if grad_clip:
        clip_by_global_norm(grads, grad_clip)
    for (_, t), g in zip(leaves, grads):
        t.grad = g
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


@contextlib.contextmanager
def full_f32() -> typing.Iterator[None]:
    """float32 products and convolutions computed in float32 (TF32 off),
    the counterpart of the reference's ``Precision.HIGHEST``."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with full_f32_convolutions():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def make_train_step(
    config: TrainingConfig, steps_per_epoch: int = 1000
) -> typing.Callable:
    """Build the train step for a voice config.

    ``train_step(state, batch, noise=None, generator=None, shard=None)``
    updates the discriminators, then the generator (against the updated
    discriminators, as the reference), in place; returns ``(state,
    metrics)`` with 0-dim tensors.  With ``shard`` it is one rank's part of
    the data-parallel step (module docstring): ``batch`` holds the rank's
    rows, ``noise`` the global batch's draws.  The generator forward runs
    once, with gradients: the D step takes its output detached, since the
    D update touches none of G's parameters.  ``mark(name)`` is called
    where each part of the step begins: ``"g_forward"`` (the generator, and the
    discriminators on its output for its loss), ``"mas"``, ``"d_step"``
    (the discriminators' losses and gradients), ``"g_backward"``,
    ``"optimizer"`` (either update), and ``"end"``.
    """
    model = VitsModel(
        config.model, decoder_dtype=torch.float32, stage_max_channels=0
    )

    def train_step(
        state: TrainState,
        batch: TrainBatch,
        noise: typing.Optional[TrainNoise] = None,
        generator: typing.Optional[torch.Generator] = None,
        mark: typing.Callable[[str], None] = _no_mark,
        shard: typing.Optional[Shard] = None,
    ) -> typing.Tuple[TrainState, typing.Dict[str, torch.Tensor]]:
        lr = learning_rate(config, state.step, steps_per_epoch)
        # the mean losses' share of their global mean: 1 / world (a power
        # of two scales exactly)
        share = 1.0 if shard is None else 1.0 / shard.world
        with full_f32():
            mark("g_forward")
            out = generator_forward(
                model, config, state.params, batch, noise=noise,
                generator=generator, mark=mark, shard=shard,
            )
            y_real = out["y_real"].detach()

            # ---- discriminator update ----
            mark("d_step")
            real_logits, _ = discriminate(state.disc_params, y_real)
            fake_logits, _ = discriminate(
                state.disc_params, out["y_hat"].detach()
            )
            loss_d = discriminator_adv_loss(real_logits, fake_logits)
            grads_d = torch.autograd.grad(
                loss_d * share, [t for _, t in state.d_leaves],
                allow_unused=True,
            )
            mark("optimizer")
            _update(state.opt_d, state.d_leaves, grads_d, lr,
                    config.grad_clip, shard)

            # ---- generator update ----
            mark("g_forward")
            with torch.no_grad():  # real feature maps are targets only
                _, fmaps_r = discriminate(state.disc_params, y_real)
            fake_logits, fmaps_f = discriminate(
                state.disc_params, out["y_hat"]
            )
            loss_adv = generator_adv_loss(fake_logits)
            loss_fm = feature_matching_loss(fmaps_r, fmaps_f)
            # this rank's part of the generator loss: the KL and duration
            # terms are over the global normalizers already
            objective = (
                (out["loss_mel"] * config.c_mel + loss_adv + loss_fm) * share
                + out["loss_kl"] * config.c_kl
                + out["loss_dur"]
            )
            mark("g_backward")
            grads_g = torch.autograd.grad(
                objective, [t for _, t in state.g_leaves], allow_unused=True
            )
            mark("optimizer")
            _update(state.opt_g, state.g_leaves, grads_g, lr,
                    config.grad_clip, shard)
            mark("end")
        state.step += 1
        metrics = {
            "loss_mel": out["loss_mel"],
            "loss_kl": out["loss_kl"],
            "loss_dur": out["loss_dur"],
            "loss_adv": loss_adv,
            "loss_fm": loss_fm,
            "loss_d": loss_d,
        }
        metrics = {k: v.detach() for k, v in metrics.items()}
        if shard is not None:
            # the global values: sums of the ranks' shares
            parts = torch.stack([
                v if k in ("loss_kl", "loss_dur") else v * share
                for k, v in metrics.items()
            ])
            metrics = dict(zip(metrics, all_reduce_sum([parts])[0]))
        loss_g = (
            metrics["loss_mel"] * config.c_mel
            + metrics["loss_kl"] * config.c_kl
            + metrics["loss_dur"]
            + metrics["loss_adv"]
            + metrics["loss_fm"]
        )
        return state, {"loss_g": loss_g, **metrics}

    return train_step


__all__ = [
    "Shard",
    "TrainBatch",
    "TrainNoise",
    "TrainState",
    "generator_forward",
    "init_train_state",
    "init_training_params",
    "make_train_step",
    "kl_loss",
]
