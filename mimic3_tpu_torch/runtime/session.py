"""Synthesis session on one torch device: buckets, two-stage flow, stats.

Counterpart of ``mimic3_tpu/runtime/session.py::VitsSession`` with the
surface the voice layer calls (``synthesize_ids``,
``synthesize_ids_batch``, ``get_shared``, ``stats``).  Inputs are padded to
the same text, batch and frame buckets as the reference; synthesis is a
duration pass, one host sync on the frame totals, then a decode pass over
the frame bucket covering the longest output.

Not ported yet: speculative decode, chunked/streaming decode, warmup and
the warmed-bucket fallback, and multi-device meshes.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import typing

import numpy as np
import torch

from mimic3_tpu.config import TrainingConfig
from mimic3_tpu.runtime.session import SessionStats, hit_key, pick_bucket

from ..models.vits.model import VitsModel, mix_seed
from .convert import to_torch_params

_LOGGER = logging.getLogger(__name__)


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@contextlib.contextmanager
def full_f32_convolutions() -> typing.Iterator[None]:
    """Run float32 convolutions in float32.

    cuDNN computes them in TF32 by default (about three decimal digits),
    which would move the encoder's and duration predictor's outputs away
    from the reference; the decoder's speed path is its bf16 dtype.
    The flag is process-wide: it is restored on exit.
    """
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = previous


class TorchVitsSession:
    """A voice's synthesis engine on one torch device."""

    _SHARED: typing.Dict[str, "TorchVitsSession"] = {}
    _SHARED_LOCK = threading.Lock()

    def __init__(
        self,
        config: TrainingConfig,
        params: typing.Mapping[str, typing.Any],
        *,
        deterministic: bool = False,
        seed: int = 0,
        device: typing.Union[str, torch.device, None] = None,
    ):
        self.config = config
        self.device = torch.device(device) if device else default_device()
        self.deterministic = deterministic
        decoder_dtype = (
            torch.float32
            if deterministic
            else getattr(torch, config.tpu.decoder_dtype)
        )
        stage_max = config.tpu.pallas_stage_max_channels
        if stage_max is None:
            stage_max = 32 if self.device.type == "cuda" else 0
        self.model = VitsModel(
            config.model,
            decoder_dtype=decoder_dtype,
            stage_max_channels=stage_max,
        )
        self.params = to_torch_params(dict(params), self.device)
        # fused decoder stages: weights laid out for the kernel once
        self.stage_weights = self.model.pack_decoder(
            self.params["dec"], self.device
        )
        self.text_buckets = tuple(config.tpu.text_buckets)
        self.frame_buckets = tuple(config.tpu.frame_buckets)
        self.batch_buckets = tuple(sorted(config.tpu.batch_buckets)) or (1,)
        self.stats = SessionStats()
        self.seed = seed
        self._call_counter = 0
        self._lock = threading.Lock()
        self._multispeaker = config.model.is_multispeaker

    @classmethod
    def get_shared(
        cls,
        key: str,
        factory: typing.Callable[[], "TorchVitsSession"],
    ) -> "TorchVitsSession":
        with cls._SHARED_LOCK:
            session = cls._SHARED.get(key)
            if session is None:
                session = factory()
                cls._SHARED[key] = session
            return session

    def _next_seed(self, seed: typing.Optional[int] = None) -> int:
        if seed is not None:
            return int(seed)
        if self.deterministic:
            return self.seed
        with self._lock:
            self._call_counter += 1
            counter = self._call_counter
        return mix_seed(self.seed, counter)

    # -- synthesis ---------------------------------------------------------------

    @torch.inference_mode()
    @full_f32_convolutions()
    def synthesize_ids_batch(
        self,
        id_sequences: typing.Sequence[typing.Sequence[int]],
        *,
        speaker_ids: typing.Optional[typing.Sequence[int]] = None,
        length_scale: float = 1.0,
        noise_scale: float = 0.667,
        noise_w: float = 0.8,
        seed: typing.Optional[int] = None,
    ) -> typing.List[np.ndarray]:
        """Synthesize a batch of phoneme-id sequences -> float32 waveforms.

        Batches past the largest batch bucket are split, sequences past the
        largest text bucket truncated, and outputs past the largest frame
        bucket cut there (as the reference does when serving).
        """
        start = time.perf_counter()
        batch = len(id_sequences)
        max_bb = self.batch_buckets[-1]
        if batch > max_bb:
            out: typing.List[np.ndarray] = []
            for i in range(0, batch, max_bb):
                out.extend(
                    self.synthesize_ids_batch(
                        id_sequences[i : i + max_bb],
                        speaker_ids=(
                            None
                            if speaker_ids is None
                            else speaker_ids[i : i + max_bb]
                        ),
                        length_scale=length_scale,
                        noise_scale=noise_scale,
                        noise_w=noise_w,
                        seed=seed,
                    )
                )
            return out
        max_text = self.text_buckets[-1]
        if any(len(s) > max_text for s in id_sequences):
            _LOGGER.warning(
                "Truncating %d phoneme sequence(s) to the largest text "
                "bucket (%d)",
                sum(1 for s in id_sequences if len(s) > max_text),
                max_text,
            )
            id_sequences = [list(s)[:max_text] for s in id_sequences]
        b_bucket = pick_bucket(batch, self.batch_buckets)
        lengths = np.ones((b_bucket,), np.int64)  # pad rows: 1 phoneme
        lengths[:batch] = [len(s) for s in id_sequences]
        t_bucket = pick_bucket(int(lengths[:batch].max()), self.text_buckets)
        ids = np.zeros((b_bucket, t_bucket), np.int64)
        for i, seq in enumerate(id_sequences):
            ids[i, : len(seq)] = np.asarray(seq, np.int64)
        sid = np.zeros((b_bucket,), np.int64)
        if speaker_ids is not None:
            sid[:batch] = np.asarray(speaker_ids, np.int64)

        call_seed = self._next_seed(seed)
        ids_t = torch.from_numpy(ids).to(self.device)
        lengths_t = torch.from_numpy(lengths).to(self.device)
        sid_t = (
            torch.from_numpy(sid).to(self.device)
            if self._multispeaker
            else None
        )

        self.stats.record_hit(hit_key("duration", b_bucket, t_bucket))
        durations, totals = self.model.infer_durations(
            self.params,
            ids_t,
            lengths_t,
            call_seed,
            float(length_scale),
            float(noise_w),
            sid=sid_t,
        )
        totals_np = totals.cpu().numpy()  # the one host sync
        needed = int(totals_np[:batch].max())
        max_frames = self.frame_buckets[-1]
        if needed > max_frames:
            _LOGGER.warning(
                "Output of %d frames exceeds cap %d; truncating",
                needed,
                max_frames,
            )
            needed = max_frames
            # clamp the durations so sample lengths match the audio
            cum = torch.clamp(torch.cumsum(durations, dim=1), max=needed)
            durations = torch.cat(
                [cum[:, :1], cum[:, 1:] - cum[:, :-1]], dim=1
            ).to(torch.int32)
        f_bucket = pick_bucket(needed, self.frame_buckets)

        self.stats.record_hit(hit_key("decode", b_bucket, t_bucket, f_bucket))
        audio, sample_lengths = self.model.decode_frames(
            self.params,
            ids_t,
            lengths_t,
            durations,
            f_bucket,
            call_seed,
            float(noise_scale),
            sid=sid_t,
            stage_weights=self.stage_weights,
        )
        audio_np = audio.float().cpu().numpy()
        sample_lengths_np = sample_lengths.cpu().numpy()
        results = [
            audio_np[i, : int(sample_lengths_np[i])] for i in range(batch)
        ]

        elapsed = time.perf_counter() - start
        audio_sec = float(sample_lengths_np[:batch].sum()) / (
            self.config.audio.sample_rate
        )
        self.stats.record(elapsed, audio_sec)
        _LOGGER.debug(
            "RTF: %s (batch=%d, t_bucket=%d, f_bucket=%d)",
            self.stats.last_rtf, batch, t_bucket, f_bucket,
        )
        return results

    def synthesize_ids(
        self,
        phoneme_ids: typing.Sequence[int],
        *,
        speaker_id: typing.Optional[int] = None,
        length_scale: float = 1.0,
        noise_scale: float = 0.667,
        noise_w: float = 0.8,
        seed: typing.Optional[int] = None,
    ) -> np.ndarray:
        """Single utterance -> float32 waveform."""
        return self.synthesize_ids_batch(
            [phoneme_ids],
            speaker_ids=None if speaker_id is None else [speaker_id],
            length_scale=length_scale,
            noise_scale=noise_scale,
            noise_w=noise_w,
            seed=seed,
        )[0]
