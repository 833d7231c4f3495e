"""Voice configuration schema.

Wire-compatible with the reference's ``config.json`` voice files
(reference: mimic3_tts/config.py:31-363) but with self-contained JSON
(de)serialization — no ``dataclasses_json`` dependency — and extra fields
for the runtime (compute dtype, bucket sizes).

Unknown JSON keys are ignored so newer/older voice configs still load.

Port copy of ``mimic3_tpu/config.py``.
"""

from __future__ import annotations

import collections.abc
import dataclasses
import json
import typing
from dataclasses import dataclass, field, fields
from enum import Enum
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# Generic dataclass <-> dict plumbing
# ---------------------------------------------------------------------------


def _to_jsonable(value: typing.Any) -> typing.Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {
            f.name: _to_jsonable(getattr(value, f.name))
            for f in fields(value)
        }
    if isinstance(value, Enum):
        return value.value
    if isinstance(value, Path):
        return str(value)
    if isinstance(value, (list, tuple)):
        return [_to_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {k: _to_jsonable(v) for k, v in value.items()}
    return value


def _from_jsonable(ftype: typing.Any, value: typing.Any) -> typing.Any:
    """Coerce a JSON value into the (possibly generic) field type."""
    if value is None:
        return None

    origin = typing.get_origin(ftype)
    args = typing.get_args(ftype)

    if origin is typing.Union:
        # Optional[X] and Union[str, Enum]-style fields: try each arm.
        for arm in args:
            if arm is type(None):
                continue
            try:
                return _from_jsonable(arm, value)
            except (TypeError, ValueError, KeyError):
                continue
        return value

    if dataclasses.is_dataclass(ftype):
        return dataclass_from_dict(ftype, value)

    if isinstance(ftype, type) and issubclass(ftype, Enum):
        return ftype(value)

    if origin in (list, typing.List):
        inner = args[0] if args else typing.Any
        return [_from_jsonable(inner, v) for v in value]

    if origin in (tuple, typing.Tuple):
        if args and args[-1] is Ellipsis:
            return tuple(_from_jsonable(args[0], v) for v in value)
        if args:
            return tuple(_from_jsonable(a, v) for a, v in zip(args, value))
        return tuple(value)

    if origin in (dict, typing.Dict, collections.abc.Mapping):
        return dict(value)

    if ftype is float and isinstance(value, (int, float)):
        return float(value)
    if ftype is int and isinstance(value, (int, float)):
        return int(value)

    return value


_T = typing.TypeVar("_T")


def dataclass_from_dict(cls: typing.Type[_T], data: typing.Mapping) -> _T:
    """Build dataclass ``cls`` from a dict, ignoring unknown keys."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in fields(cls):  # type: ignore[arg-type]
        if f.name in data:
            kwargs[f.name] = _from_jsonable(hints[f.name], data[f.name])
    return cls(**kwargs)  # type: ignore[call-arg]


def recursive_update(
    base: typing.Dict[typing.Any, typing.Any],
    new: typing.Mapping[typing.Any, typing.Any],
) -> None:
    """Recursively overlay ``new`` onto ``base`` in place
    (reference semantics: mimic3_tts/config.py:351-363)."""
    for key, value in new.items():
        if isinstance(value, collections.abc.Mapping) and (
            base.get(key) is not None
        ):
            recursive_update(base[key], value)
        else:
            base[key] = value


# ---------------------------------------------------------------------------
# Enums
# ---------------------------------------------------------------------------


# single source of truth lives with the encoder implementation
from .text.phonemes2ids import BlankBetween  # noqa: E402


class Phonemizer(str, Enum):
    """Method used to convert text to phonemes
    (reference: mimic3_tts/config.py:194-200)."""

    SYMBOLS = "symbols"
    GRUUT = "gruut"
    ESPEAK = "espeak"
    EPITRAN = "epitran"


class Aligner(str, Enum):
    KALDI_ALIGN = "kaldi_align"


class TextCasing(str, Enum):
    LOWER = "lower"
    UPPER = "upper"


class MetadataFormat(str, Enum):
    TEXT = "text"
    PHONEMES = "phonemes"
    PHONEME_IDS = "ids"


# ---------------------------------------------------------------------------
# Config dataclasses
# ---------------------------------------------------------------------------


@dataclass
class AudioConfig:
    """Audio framing and mel-normalization constants
    (reference: mimic3_tts/config.py:31-109)."""

    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    mel_channels: int = 80
    sample_rate: int = 22050
    sample_bytes: int = 2
    channels: int = 1
    mel_fmin: float = 0.0
    mel_fmax: typing.Optional[float] = None
    ref_level_db: float = 20.0
    spec_gain: float = 1.0

    signal_norm: bool = True
    min_level_db: float = -100.0
    max_norm: float = 1.0
    clip_norm: bool = True
    symmetric_norm: bool = True
    do_dynamic_range_compression: bool = True
    convert_db_to_amp: bool = True

    do_trim_silence: bool = False
    trim_silence_db: float = 40.0
    trim_margin_sec: float = 0.01
    trim_keep_sec: float = 0.25

    scale_mels: bool = False

    def normalize(self, mel_db: np.ndarray) -> np.ndarray:
        """Map dB mels into [0, max_norm] or [-max_norm, max_norm]."""
        mel_norm = ((mel_db - self.ref_level_db) - self.min_level_db) / (
            -self.min_level_db
        )
        if self.symmetric_norm:
            mel_norm = ((2 * self.max_norm) * mel_norm) - self.max_norm
            if self.clip_norm:
                mel_norm = np.clip(mel_norm, -self.max_norm, self.max_norm)
        else:
            mel_norm = self.max_norm * mel_norm
            if self.clip_norm:
                mel_norm = np.clip(mel_norm, 0, self.max_norm)
        return mel_norm

    def denormalize(self, mel_db: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`normalize`."""
        if self.symmetric_norm:
            mel_denorm = mel_db
            if self.clip_norm:
                mel_denorm = np.clip(mel_denorm, -self.max_norm, self.max_norm)
            mel_denorm = (
                (mel_denorm + self.max_norm)
                * -self.min_level_db
                / (2 * self.max_norm)
            ) + self.min_level_db
        else:
            mel_denorm = mel_db
            if self.clip_norm:
                mel_denorm = np.clip(mel_denorm, 0, self.max_norm)
            mel_denorm = (
                mel_denorm * -self.min_level_db / self.max_norm
            ) + self.min_level_db
        return mel_denorm + self.ref_level_db


@dataclass
class ModelConfig:
    """VITS hyperparameters (reference: mimic3_tts/config.py:113-143)."""

    num_symbols: int = 0
    n_speakers: int = 1

    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
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
    n_layers_q: int = 3
    use_spectral_norm: bool = False
    gin_channels: int = 0
    use_sdp: bool = True

    decoder_type: str = "hifigan"
    """Decoder family: "hifigan" (reference voices) or "mb-istft"
    (multi-band iSTFT decoder — mimic3-tpu extension for newly trained
    voices; its time against HiFi-GAN on the card is in PERF.md)."""

    subbands: int = 4
    istft_n_fft: int = 16
    istft_hop: int = 4
    mb_upsample_rates: typing.Tuple[int, ...] = (4, 4)
    mb_upsample_kernel_sizes: typing.Tuple[int, ...] = (16, 16)

    @property
    def is_multispeaker(self) -> bool:
        return self.n_speakers > 1


@dataclass
class PhonemesConfig:
    """Phoneme-to-id encoding options
    (reference: mimic3_tts/config.py:147-191)."""

    phoneme_separator: str = " "
    word_separator: str = "#"
    phoneme_to_id: typing.Optional[typing.Dict[str, int]] = None
    pad: typing.Optional[str] = "_"
    bos: typing.Optional[str] = None
    eos: typing.Optional[str] = None
    blank: typing.Optional[str] = "#"
    blank_word: typing.Optional[str] = None
    blank_between: typing.Union[str, BlankBetween] = BlankBetween.WORDS
    blank_at_start: bool = True
    blank_at_end: bool = True
    simple_punctuation: bool = True
    punctuation_map: typing.Optional[typing.Dict[str, str]] = None
    separate: typing.Optional[typing.List[str]] = None
    separate_graphemes: bool = False
    separate_tones: bool = False
    tone_before: bool = False
    phoneme_map: typing.Optional[typing.Dict[str, str]] = None
    auto_bos_eos: bool = False
    minor_break: typing.Optional[str] = "|"
    major_break: typing.Optional[str] = "‖"  # ‖
    break_phonemes_into_graphemes: bool = False
    break_phonemes_into_codepoints: bool = False
    drop_stress: bool = False
    symbols: typing.Optional[typing.List[str]] = None

    def split_word_phonemes(
        self, phonemes_str: str
    ) -> typing.List[typing.List[str]]:
        """Split a CSV phoneme string into per-word phoneme lists."""
        return [
            word.split(self.phoneme_separator)
            for word in phonemes_str.split(self.word_separator)
        ]

    def join_word_phonemes(
        self, word_phonemes: typing.List[typing.List[str]]
    ) -> str:
        return self.word_separator.join(
            self.phoneme_separator.join(wp) for wp in word_phonemes
        )


@dataclass
class DatasetConfig:
    name: str = ""
    metadata_format: MetadataFormat = MetadataFormat.TEXT
    multispeaker: bool = False
    text_language: typing.Optional[str] = None
    audio_dir: typing.Optional[str] = None
    cache_dir: typing.Optional[str] = None


@dataclass
class AlignerConfig:
    aligner: typing.Optional[Aligner] = None
    casing: typing.Optional[TextCasing] = None


@dataclass
class InferenceConfig:
    """Synthesis-time defaults (reference: mimic3_tts/config.py:257-271)."""

    length_scale: float = 1.0
    noise_scale: float = 0.667
    noise_w: float = 0.8

    minor_break_ms: typing.Optional[int] = None
    major_break_ms: typing.Optional[int] = None
    auto_append_text: typing.Optional[str] = None


@dataclass
class TpuConfig:
    """Runtime knobs, the ``tpu`` section of a voice config (mimic3-tpu
    extension; absent from reference configs and ignored by the
    reference)."""

    compute_dtype: str = "float32"
    """dtype for the model compute path ("float32" or "bfloat16")."""

    decoder_dtype: str = "bfloat16"
    """dtype for the HiFi-GAN decoder stack (bf16 halves HBM traffic; audio
    is ultimately quantized to int16 so bf16 is inaudible)."""

    pallas_stage_max_channels: typing.Optional[int] = None
    """Stages with channels <= this run as one fused kernel launch
    (ops/stage.py).  None = auto: on the card 32 for an f32 decoder and
    64 for bf16 (runtime/session.py STAGE_MAX_CHANNELS, set from the
    sweep in PERF.md); off on the CPU.  0 disables."""

    text_buckets: typing.Tuple[int, ...] = (32, 64, 128, 256, 512)
    """Static phoneme-length buckets; inputs are padded up to the nearest."""

    frame_buckets: typing.Tuple[int, ...] = (
        128, 256, 512, 1024, 2048, 4096,
    )
    """Static spectrogram-frame buckets for the decode stage."""

    speculative_decode: bool = True
    """Dispatch the decode at a predicted frame bucket before the
    duration-totals host sync (serving hides one device round trip per
    request; mispredictions fall back to a normal decode).  Prior
    noise is frame-indexed, so speculation never changes the audio."""

    batch_buckets: typing.Tuple[int, ...] = (1, 2, 4, 8, 16)
    """Static batch-size buckets; the scheduler's variable batches are
    padded up to the nearest so intermediate batch sizes stay on the
    warmed signatures."""

    batched_continuations: bool = True
    """Streams that started in one fused batched call also decode their
    CONTINUATION windows as one batched device call per window (a
    demand-paced driver thread), instead of batch-1 calls per stream —
    under sustained concurrent streaming the continuations otherwise
    serialize on the device.  Audio is bit-identical either way (prior
    noise is frame-indexed and shared across batch rows)."""


@dataclass
class TrainingConfig:
    """Top-level voice config (reference: mimic3_tts/config.py:275-363)."""

    seed: int = 1234
    epochs: int = 10000
    learning_rate: float = 2e-4
    betas: typing.Tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-9
    batch_size: int = 32
    fp16_run: bool = False
    lr_decay: float = 0.999875
    segment_size: int = 8192
    init_lr_ratio: float = 1.0
    warmup_epochs: int = 0
    c_mel: float = 45
    c_kl: float = 1.0
    grad_clip: typing.Optional[float] = None

    min_seq_length: typing.Optional[int] = None
    max_seq_length: typing.Optional[int] = None
    min_spec_length: typing.Optional[int] = None
    max_spec_length: typing.Optional[int] = None
    min_speaker_utterances: typing.Optional[int] = None

    last_epoch: int = 1
    global_step: int = 1
    best_loss: typing.Optional[float] = None
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    phonemes: PhonemesConfig = field(default_factory=PhonemesConfig)
    text_aligner: AlignerConfig = field(default_factory=AlignerConfig)
    text_language: typing.Optional[str] = None
    phonemizer: typing.Optional[Phonemizer] = None
    datasets: typing.List[DatasetConfig] = field(default_factory=list)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)

    version: int = 1
    git_commit: str = ""

    @property
    def is_multispeaker(self) -> bool:
        return self.model.is_multispeaker or any(
            d.multispeaker for d in self.datasets
        )

    # -- (de)serialization ---------------------------------------------------

    def to_dict(self) -> typing.Dict[str, typing.Any]:
        return _to_jsonable(self)

    @staticmethod
    def from_dict(data: typing.Mapping) -> "TrainingConfig":
        return dataclass_from_dict(TrainingConfig, data)

    def save(self, config_file: typing.TextIO) -> None:
        json.dump(self.to_dict(), config_file, indent=4)

    @staticmethod
    def load(config_file: typing.TextIO) -> "TrainingConfig":
        return TrainingConfig.from_dict(json.load(config_file))

    @staticmethod
    def load_path(path: typing.Union[str, Path]) -> "TrainingConfig":
        with open(path, "r", encoding="utf-8") as f:
            return TrainingConfig.load(f)

    @staticmethod
    def load_and_merge(
        config: "TrainingConfig",
        config_files: typing.Iterable[
            typing.Union[str, Path, typing.TextIO]
        ],
    ) -> "TrainingConfig":
        """Overlay one or more JSON config files onto ``config``."""
        base_dict = config.to_dict()
        for maybe_file in config_files:
            if isinstance(maybe_file, (str, Path)):
                with open(maybe_file, "r", encoding="utf-8") as f:
                    new_dict = json.load(f)
            else:
                # borrowed handle: read it but leave it open (only
                # files opened here get closed here)
                new_dict = json.load(maybe_file)
            recursive_update(base_dict, new_dict)
        return TrainingConfig.from_dict(base_dict)
