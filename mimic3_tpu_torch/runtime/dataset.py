"""Training dataset: LJSpeech-style metadata + WAV audio -> TrainBatch.

Port copy of ``mimic3_tpu/runtime/dataset.py`` (host-only numpy); batches
carry CPU torch tensors, moved to the device by the trainer.  The same
seed gives the same batch stream as the reference (both shuffle with the
stdlib ``random``).

The reference ecosystem trains nothing (training lived in mimic3-train), but
its ``DatasetConfig`` documents the expected layout
(reference: mimic3_tts/config.py:225-245): a ``metadata.csv`` of
``id|text`` (or ``id|speaker|text``) rows plus ``<audio_dir>/<id>.wav``.

Text is phonemized with the voice's own front end so training and
inference share one tokenizer; batches are padded to static bucket
shapes so a few shapes serve many batches.
"""

from __future__ import annotations

import csv
import logging
import random
import typing
import wave
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..config import TrainingConfig
from .session import pick_bucket

_LOGGER = logging.getLogger(__name__)


@dataclass
class Utterance:
    utt_id: str
    phoneme_ids: typing.List[int]
    audio_path: Path
    speaker_id: int = 0


def make_frontend(voice_dir: typing.Union[str, Path]):
    """Text front end (phonemizer + id encoder) without model weights.

    Uses the voice-directory's config.json + phonemes.txt only, so a
    training run needs no ``generator.*`` file to start from scratch.
    """
    from ..text import load_phoneme_ids
    from .voice import _VOICE_CLASSES

    voice_dir = Path(voice_dir)
    config = TrainingConfig.load_path(voice_dir / "config.json")
    with open(voice_dir / "phonemes.txt", "r", encoding="utf-8") as f:
        phoneme_to_id = load_phoneme_ids(f)
    cls = _VOICE_CLASSES.get(config.phonemizer)
    if cls is None:
        raise ValueError(f"Unsupported phonemizer: {config.phonemizer}")
    return cls(
        config=config,
        session=None,  # front-end only
        phoneme_to_id=phoneme_to_id,
        location=voice_dir,
    )


def load_metadata(
    metadata_path: typing.Union[str, Path],
    audio_dir: typing.Union[str, Path],
    frontend,
    *,
    multispeaker: bool = False,
    speaker_map: typing.Optional[typing.Mapping[str, int]] = None,
    delimiter: str = "|",
) -> typing.List[Utterance]:
    """Parse metadata.csv and phonemize every row."""
    audio_dir = Path(audio_dir)
    utterances: typing.List[Utterance] = []
    speakers: typing.Dict[str, int] = dict(speaker_map or {})

    with open(metadata_path, "r", encoding="utf-8") as f:
        for row in csv.reader(f, delimiter=delimiter):
            if not row:
                continue
            utt_id = row[0]
            if multispeaker and len(row) >= 3:
                speaker_name, text = row[1], row[-1]
                if speaker_name not in speakers:
                    speakers[speaker_name] = len(speakers)
                speaker_id = speakers[speaker_name]
            else:
                text, speaker_id = row[-1], 0

            audio_path = audio_dir / f"{utt_id}.wav"
            if not audio_path.is_file():
                _LOGGER.warning("Missing audio: %s", audio_path)
                continue

            word_phonemes: typing.List[typing.List[str]] = []
            for sent_phonemes, _bt in frontend.text_to_phonemes(text):
                word_phonemes.extend(sent_phonemes)
            ids = frontend.phonemes_to_ids(word_phonemes)
            if not ids:
                _LOGGER.warning("No phonemes for %s", utt_id)
                continue
            utterances.append(
                Utterance(utt_id, ids, audio_path, speaker_id)
            )
    _LOGGER.info("Loaded %d utterances", len(utterances))
    return utterances


def read_wav(path: Path, expected_rate: int) -> np.ndarray:
    """16-bit PCM WAV -> float32 in [-1, 1]."""
    with wave.open(str(path), "rb") as w:
        if w.getframerate() != expected_rate:
            raise ValueError(
                f"{path}: sample rate {w.getframerate()} != "
                f"{expected_rate} (resample offline)"
            )
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: expected 16-bit mono PCM")
        data = np.frombuffer(
            w.readframes(w.getnframes()), dtype=np.int16
        )
    return data.astype(np.float32) / 32768.0


def batches(
    utterances: typing.Sequence[Utterance],
    config: TrainingConfig,
    batch_size: int,
    *,
    seed: int = 0,
    text_buckets: typing.Sequence[int] = (32, 64, 128, 256, 512),
    frame_buckets: typing.Sequence[int] = (128, 256, 512, 1024, 2048),
    drop_last: bool = False,
) -> typing.Iterator["object"]:
    """Infinite shuffled iterator of padded TrainBatch objects.

    Utterances are length-sorted into chunks before batching so one batch
    pads to similar bucket shapes (minimal wasted compute, few distinct
    shapes).
    """
    import torch

    from ..models.vits.train import TrainBatch

    hop = config.audio.hop_length
    segment_frames = config.segment_size // hop
    rng = random.Random(seed)
    order = sorted(range(len(utterances)),
                   key=lambda i: len(utterances[i].phoneme_ids))

    while True:
        # shuffle in windows to keep similar lengths together
        window = batch_size * 8
        shuffled: typing.List[int] = []
        for start in range(0, len(order), window):
            chunk = order[start : start + window]
            rng.shuffle(chunk)
            shuffled.extend(chunk)

        for start in range(0, len(shuffled), batch_size):
            idx = shuffled[start : start + batch_size]
            if len(idx) < batch_size:
                if drop_last:
                    continue
                # repeat until FULL (one slice underfills when the
                # remainder is < batch_size/2, yielding ragged arrays)
                reps = -(-batch_size // len(idx))
                idx = (idx * reps)[:batch_size]

            items = [utterances[i] for i in idx]
            audios = []
            for item in items:
                audio = read_wav(
                    item.audio_path, config.audio.sample_rate
                )
                frames = len(audio) // hop
                if frames < segment_frames:
                    # pad short clips up to one segment so slicing has
                    # a full window; the TRUE length is kept separately
                    # so masks/losses don't treat the padding as speech
                    audio = np.pad(
                        audio, (0, (segment_frames - frames) * hop)
                    )
                audios.append((audio, max(frames, 1)))

            text_lengths = np.array(
                [len(i.phoneme_ids) for i in items], np.int32
            )
            # true (pre-padding) frame counts: KL/MAS/posterior masks
            # must not count appended silence as valid speech
            spec_lengths = np.array(
                [frames for _a, frames in audios], np.int32
            )
            # training is offline: growing past the configured ladder
            # (one more shape) beats truncating a long clip
            t_bucket = pick_bucket(
                int(text_lengths.max()), text_buckets, grow=True
            )
            # at least one full segment so slicing never leaves the
            # padded audio (true lengths can be < segment_frames)
            f_bucket = pick_bucket(
                max(int(spec_lengths.max()), segment_frames),
                frame_buckets,
                grow=True,
            )

            ids = np.zeros((batch_size, t_bucket), np.int32)
            audio_arr = np.zeros(
                (batch_size, f_bucket * hop), np.float32
            )
            for row, item in enumerate(items):
                ids[row, : len(item.phoneme_ids)] = item.phoneme_ids
                a = audios[row][0]
                n = min(len(a), f_bucket * hop)
                audio_arr[row, :n] = a[:n]

            yield TrainBatch(
                phoneme_ids=torch.from_numpy(ids),
                text_lengths=torch.from_numpy(text_lengths),
                audio=torch.from_numpy(audio_arr),
                spec_lengths=torch.from_numpy(spec_lengths),
                speaker_ids=(
                    torch.from_numpy(
                        np.array(
                            [i.speaker_id for i in items], np.int32
                        )
                    )
                    if config.model.is_multispeaker
                    else None
                ),
            )
