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

On a mesh (``init_train_state(..., mesh=, use_tp=)``, the reference's
step with its state placed by ``param_sharding`` under a ``dp x tp``
mesh) the state trains one copy of the trees per local dp row (rows on
the same devices share one) and the step runs each local row's rows:
the dp sums (normalizers, gradients, metrics) add the local rows and go
over the mesh's dp group, never the world, which would count each
replicated gradient T times and add different parts of a split leaf.
With ``use_tp`` the generator's ``_TP_RULES`` leaves are
``parallel/tensor.py::Split``s whose parts are leaves of their own, each
updated by Adam on its device; the discriminators and the optimizers'
state stay whole on each row's first device.  Over a tp row that spans
processes every rank of the row draws the same noise and runs the row's
program on its device; the global norm adds the parts over the row, and
the row's copies of the replicated gradients are averaged over it, which
keeps those copies bitwise equal where a kernel sums in a varying order.
"""

from __future__ import annotations

import contextlib
import math
import typing
from dataclasses import dataclass, field

import torch

from ...config import TrainingConfig
from ...ops.stft import mel_spectrogram, spectrogram
from ...parallel import Mesh, all_reduce_sum, shard_params
from ...parallel.mesh import shard_rows
from ...parallel.tensor import Split
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
    """One dp row's part of a data-parallel step (a rank's, without a
    mesh): the batch it gets is rows ``[rank * b, (rank + 1) * b)`` of a
    global batch of ``world * b``."""

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
    # drawn where the generator lives (a dp row may sit on another
    # device), then moved
    drawn = device if generator is None else generator.device
    posterior, duration = noise.posterior, noise.duration
    if posterior is None:
        posterior = torch.randn(
            n, inter, t_spec, generator=generator, device=drawn
        )
    if duration is None and use_sdp:
        duration = torch.randn(n, 2, t_text, generator=generator,
                               device=drawn)
    if noise.starts is None:
        u = torch.rand(n, generator=generator, device=drawn)[rows]
        starts = segment_starts(u.to(device), spec_lengths, segment_frames)
    else:
        starts = noise.starts[rows]
    return TrainNoise(
        posterior=posterior[rows].to(device),
        duration=None if duration is None else duration[rows].to(device),
        starts=starts.to(device),
    )


def batch_totals(batch: TrainBatch, hop: int) -> torch.Tensor:
    """[valid phonemes, valid frames] of ``batch`` as float32, the sums of
    its text and spectrogram masks (``samples // hop`` frames)."""
    t_text, t_spec = batch.phoneme_ids.shape[1], batch.audio.shape[1] // hop
    return torch.stack([
        torch.clamp(batch.text_lengths, 0, t_text).sum(),
        torch.clamp(batch.spec_lengths, 0, t_spec).sum(),
    ]).float()


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
    totals: typing.Optional[torch.Tensor] = None,
) -> typing.Dict[str, torch.Tensor]:
    """VITS training forward pass -> losses + fake/real audio segments.

    ``mark(name)`` is called where the part ``name`` of the work begins
    (``"mas"``, then ``"g_forward"`` again), for a caller timing them.
    On a data-parallel ``shard``, ``batch`` is the shard's rows, ``noise``
    (if given) the global batch's draws, and ``totals`` the global batch's
    valid phonemes and frames (:func:`batch_totals` summed over the
    shards), which normalize the duration and KL losses.
    """
    if shard is not None and totals is None:
        raise ValueError("a data-parallel shard needs the global totals")
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
    if totals is not None:
        phonemes, frames = totals.to(x_mask.device)
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
    """(dotted name, tensor) of every leaf, in the tree's order; each part
    of a split leaf is a leaf of its own, ``name[j]`` for tp index ``j``
    (over a row that spans processes, this rank's part alone)."""
    out = []
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.extend(tree_leaves(value, path))
        elif isinstance(value, Split):
            first = 0 if value.row is None else value.row.index
            out.extend((f"{path}[{first + j}]", part)
                       for j, part in enumerate(value.parts))
        else:
            out.append((path, value))
    return out


def is_part(name: str) -> bool:
    """Whether a :func:`tree_leaves` name is a part of a split leaf."""
    return name.endswith("]")


class TrainRow(typing.NamedTuple):
    """A local dp row of a state on a mesh: its dp index, its first
    device (this rank's, on a row that spans processes) and the state
    whose trees it trains."""

    index: int
    device: torch.device
    state: "TrainState"


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
    # on a mesh: the mesh and this process's dp rows, the first training
    # this state; a row on other devices trains a state of its own (its
    # step count unused), rows on the same devices share one
    mesh: typing.Optional[Mesh] = None
    rows: typing.List[TrainRow] = field(default_factory=list)


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
    params: Params,
    disc_params: Params,
    config: TrainingConfig,
    *,
    mesh: typing.Optional[Mesh] = None,
    use_tp: bool = False,
) -> TrainState:
    """A state training the given torch-layout trees with fresh
    optimizers.  Without a mesh the trees' own leaves are set to require
    grad and trained in place.  On a mesh the generator tree is placed
    per local dp row by ``parallel.shard_params`` (with ``use_tp`` the
    rules' leaves split over the row's tp devices) and the discriminators
    on each row's first device, as copies or detached aliases."""
    if mesh is None:
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
    if mesh.multiprocess and mesh.shape["tp"] > 1 and (
            mesh.tp_group is None or mesh.dp_group is None):
        raise ValueError(
            "a tp row that spans processes needs the mesh's process groups "
            "(parallel.make_global_mesh builds them)"
        )
    g_trees = shard_params(mesh, params, use_tp=use_tp, requires_grad=True)
    d_trees = shard_params(mesh, disc_params, requires_grad=True)
    states: typing.Dict[int, TrainState] = {}
    rows = []
    for row, g, d in zip(mesh.local_rows(), g_trees, d_trees):
        if id(g) not in states:
            opt_g, opt_d = make_optimizers(config, g, d)
            states[id(g)] = TrainState(
                params=g, disc_params=d, opt_g=opt_g, opt_d=opt_d,
                g_leaves=tree_leaves(g), d_leaves=tree_leaves(d),
            )
        rows.append(TrainRow(row.index, row.devices[0], states[id(g)]))
    state = rows[0].state
    state.mesh, state.rows = mesh, rows
    return state


def global_norm(
    grads: typing.Sequence[torch.Tensor],
    parts: typing.Optional[typing.Sequence[bool]] = None,
    group: typing.Any = None,
) -> torch.Tensor:
    """The L2 norm of all ``grads`` together, on the first one's device.
    Over a tp row that spans processes (``group``, the row's) the
    ``parts`` flagged are this rank's parts of split leaves: their squares
    are summed over the row, the replicated leaves counted once."""
    device = grads[0].device
    norms = torch.stack([torch.linalg.vector_norm(g).to(device)
                         for g in grads])
    if group is None:
        return torch.linalg.vector_norm(norms)
    mask = torch.tensor(parts, device=device)
    split = all_reduce_sum([norms[mask].square().sum()], group)[0]
    return torch.sqrt(norms[~mask].square().sum() + split)


def clip_by_global_norm(
    grads: typing.List[torch.Tensor], max_norm: float,
    parts: typing.Optional[typing.Sequence[bool]] = None,
    group: typing.Any = None,
) -> None:
    """In place, ``optax.clip_by_global_norm``'s rule: scale by ``max /
    norm`` only when the global norm (:func:`global_norm`) exceeds
    ``max``."""
    norm = global_norm(grads, parts, group)
    scale = torch.clamp(max_norm / norm, max=1.0)
    by_device: typing.Dict[torch.device, typing.List[torch.Tensor]] = {}
    for g in grads:
        by_device.setdefault(g.device, []).append(g)
    for device, same in by_device.items():
        torch._foreach_mul_(same, scale.to(device))


def _dense(
    leaves: typing.List[typing.Tuple[str, torch.Tensor]],
    grads: typing.Sequence[typing.Optional[torch.Tensor]],
) -> typing.List[torch.Tensor]:
    """``grads`` with None (unused: a zero gradient, which still moves a
    parameter by its moments as optax does) made zeros, each in its
    parameter's strides (autograd may return other strides, e.g. for a
    slice of a padded table), which keeps Adam's multi-tensor kernels on
    their fast path."""
    return [
        torch.zeros_like(t) if g is None
        else g if g.stride() == t.stride()
        else torch.empty_like(t).copy_(g)
        for (_, t), g in zip(leaves, grads)
    ]


def _update(
    opt: torch.optim.Optimizer,
    leaves: typing.List[typing.Tuple[str, torch.Tensor]],
    grads: typing.List[torch.Tensor],
    lr: float,
    grad_clip: typing.Optional[float],
    group: typing.Any = None,
) -> None:
    """Adam on ``leaves`` with the summed ``grads``, clipped by the global
    norm first (over a tp row that spans processes, ``group``).  The
    gradients stay on each leaf's ``.grad``."""
    if grad_clip:
        clip_by_global_norm(grads, grad_clip,
                            [is_part(n) for n, _ in leaves], group)
    for (_, t), g in zip(leaves, grads):
        t.grad = g
    for group_ in opt.param_groups:
        group_["lr"] = lr
    opt.step()


class _Parallel(typing.NamedTuple):
    """How one step's rows combine: each local row's shard and state, the
    dp size, the dp process group the sums run over (``collective``), and
    the tp row group when a row spans processes."""

    rows: typing.List[typing.Tuple[typing.Optional[Shard], TrainState]]
    dp: int
    collective: bool
    dp_group: typing.Any = None
    tp_group: typing.Any = None
    tp: int = 1

    def sum(self, tensors: typing.List[torch.Tensor]) -> typing.List[
            torch.Tensor]:
        """The sum over the dp group (the rows of other processes)."""
        if not self.collective:
            return tensors
        return all_reduce_sum(tensors, self.dp_group)

    def apply(self, kind: str, grads_by_row, lr: float, grad_clip) -> None:
        """Sum each row's gradients of tree ``kind`` (``"g"``/``"d"``)
        over the local rows and the dp group, average the replicated ones
        over a tp row that spans processes, then step every state."""
        states = list({id(st): st for _, st in self.rows}.values())
        first = states[0]
        leaves0 = getattr(first, f"{kind}_leaves")
        total = None
        for (_, st), grads in zip(self.rows, grads_by_row):
            dense = _dense(getattr(st, f"{kind}_leaves"), grads)
            if st is not first:
                dense = [g.to(t.device) for g, (_, t) in zip(dense, leaves0)]
            total = dense if total is None else [
                a + b for a, b in zip(total, dense)]
        total = self.sum(total)
        if self.tp_group is not None:
            shared = [i for i, (n, _) in enumerate(leaves0) if not is_part(n)]
            mean = all_reduce_sum([total[i] for i in shared], self.tp_group)
            for i, g in zip(shared, mean):
                total[i] = g * (1.0 / self.tp)
        has_parts = any(is_part(n) for n, _ in leaves0)
        for st in states:
            leaves = getattr(st, f"{kind}_leaves")
            grads = total if st is first else [
                g.to(t.device) for g, (_, t) in zip(total, leaves)]
            _update(getattr(st, f"opt_{kind}"), leaves, grads, lr, grad_clip,
                    self.tp_group if has_parts else None)


def _parallel(state: TrainState, shard: typing.Optional[Shard]) -> _Parallel:
    mesh = state.mesh
    if mesh is None:
        return _Parallel([(shard, state)], 1 if shard is None
                         else shard.world, shard is not None)
    if shard is not None:
        raise ValueError("a state on a mesh takes its shards from the mesh")
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    return _Parallel(
        [(Shard(r.index, dp) if dp > 1 else None, r.state)
         for r in state.rows],
        dp, mesh.multiprocess and dp > 1, mesh.dp_group,
        mesh.tp_group if mesh.multiprocess else None, tp,
    )


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
    rows, ``noise`` the global batch's draws.  On a mesh state ``batch``
    holds this process's dp rows' rows (``parallel.
    process_local_batch_slice``), each row runs its own, and ``noise``
    and ``generator`` are the global batch's as without a mesh.  The
    generator forward runs once, with gradients: the D step takes its
    output detached, since the D update touches none of G's parameters.
    ``mark(name)`` is called where each part of the step begins:
    ``"g_forward"`` (the generator, and the discriminators on its output
    for its loss), ``"mas"``, ``"d_step"`` (the discriminators' losses and
    gradients), ``"g_backward"``, ``"optimizer"`` (either update), and
    ``"end"``.
    """
    model = VitsModel(
        config.model, decoder_dtype=torch.float32, stage_max_channels=0
    )
    hop = config.audio.hop_length

    def train_step(
        state: TrainState,
        batch: TrainBatch,
        noise: typing.Optional[TrainNoise] = None,
        generator: typing.Optional[torch.Generator] = None,
        mark: typing.Callable[[str], None] = _no_mark,
        shard: typing.Optional[Shard] = None,
    ) -> typing.Tuple[TrainState, typing.Dict[str, torch.Tensor]]:
        lr = learning_rate(config, state.step, steps_per_epoch)
        par = _parallel(state, shard)
        # the mean losses' share of their global mean: 1 / dp (a power of
        # two scales exactly)
        share = 1.0 / par.dp
        totals = None
        if par.dp > 1:
            totals = par.sum([batch_totals(batch, hop)])[0]
        n_rows = len(par.rows)
        if n_rows > 1:
            size = batch.phoneme_ids.shape[0]
            rows_of = [TrainBatch(*(
                None if t is None else t[shard_rows(k, n_rows, size)].to(
                    r.device)
                for t in (batch.phoneme_ids, batch.text_lengths,
                          batch.audio, batch.spec_lengths,
                          batch.speaker_ids)
            )) for k, r in enumerate(state.rows)]
        elif state.mesh is not None:
            rows_of = [batch.to(state.rows[0].device)]
        else:
            rows_of = [batch]
        # every local row draws the global batch's noise and keeps its
        # rows: each starts from the generator's state at the step's start
        start = (generator.get_state()
                 if generator is not None and n_rows > 1 else None)
        with full_f32():
            outs, grads_d = [], []
            for (row_shard, st), rows in zip(par.rows, rows_of):
                if start is not None:
                    generator.set_state(start)
                mark("g_forward")
                out = generator_forward(
                    model, config, st.params, rows, noise=noise,
                    generator=generator, mark=mark, shard=row_shard,
                    totals=totals,
                )
                y_real = out["y_real"].detach()

                # ---- discriminator gradients ----
                mark("d_step")
                real_logits, _ = discriminate(st.disc_params, y_real)
                fake_logits, _ = discriminate(
                    st.disc_params, out["y_hat"].detach()
                )
                loss_d = discriminator_adv_loss(real_logits, fake_logits)
                grads_d.append(torch.autograd.grad(
                    loss_d * share, [t for _, t in st.d_leaves],
                    allow_unused=True,
                ))
                outs.append((out, y_real, loss_d))
            mark("optimizer")
            par.apply("d", grads_d, lr, config.grad_clip)

            # ---- generator update ----
            metrics_by_row, grads_g = [], []
            for (_, st), (out, y_real, loss_d) in zip(par.rows, outs):
                mark("g_forward")
                with torch.no_grad():  # real feature maps are targets only
                    _, fmaps_r = discriminate(st.disc_params, y_real)
                fake_logits, fmaps_f = discriminate(
                    st.disc_params, out["y_hat"]
                )
                loss_adv = generator_adv_loss(fake_logits)
                loss_fm = feature_matching_loss(fmaps_r, fmaps_f)
                # this row's part of the generator loss: the KL and
                # duration terms are over the global normalizers already
                objective = (
                    (out["loss_mel"] * config.c_mel + loss_adv + loss_fm)
                    * share
                    + out["loss_kl"] * config.c_kl
                    + out["loss_dur"]
                )
                mark("g_backward")
                grads_g.append(torch.autograd.grad(
                    objective, [t for _, t in st.g_leaves],
                    allow_unused=True,
                ))
                metrics_by_row.append({
                    "loss_mel": out["loss_mel"],
                    "loss_kl": out["loss_kl"],
                    "loss_dur": out["loss_dur"],
                    "loss_adv": loss_adv,
                    "loss_fm": loss_fm,
                    "loss_d": loss_d,
                })
            mark("optimizer")
            par.apply("g", grads_g, lr, config.grad_clip)
            mark("end")
        state.step += 1
        names = list(metrics_by_row[0])
        if par.dp > 1:
            # the global values: sums of the rows' shares
            device = metrics_by_row[0]["loss_mel"].device
            parts = sum(
                torch.stack([
                    m[k].detach() if k in ("loss_kl", "loss_dur")
                    else m[k].detach() * share
                    for k in names
                ]).to(device)
                for m in metrics_by_row
            )
            metrics = dict(zip(names, par.sum([parts])[0]))
        else:
            metrics = {k: v.detach() for k, v in metrics_by_row[0].items()}
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
    "TrainRow",
    "TrainBatch",
    "TrainNoise",
    "TrainState",
    "generator_forward",
    "init_train_state",
    "init_training_params",
    "make_train_step",
    "kl_loss",
]
