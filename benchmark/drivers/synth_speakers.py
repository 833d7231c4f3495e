"""Offline batch synthesis over a multi-speaker voice in process: the
closed loop of :mod:`.synth_batch` with a speaker id a row.

Traffic parameters: those of :mod:`.synth_batch`.  Each row's speaker,
over all of the voice's ``n_speakers``, is drawn from the call seed (not
from the run's seed), so every run makes the same set of (call seed,
speakers) and does the same work; a call mixes about as many speakers as
it has rows.  The voice is written by :func:`benchmark.speakers.write_voice`
and every answer is judged against the reference for its own speaker.

End-to-end: ``synth_audio_s_per_s``.  Counters for the per-layer readers:
those of :mod:`.synth_batch`, and the session's ``frames_decoded`` and
``frames_returned`` diffed across the traced window where the program
keeps them.
"""

from __future__ import annotations

import gc
import sys
import time
import typing

import numpy as np
import torch

from .. import speakers as spk
from .. import textgen
from ..counts import hop as hop_of
from ..harness import TRACE_SECONDS, Artifacts, Context, Outcome
from ..voice import voice_config
from .synth_batch import _sync, _Traced, calls

SPEAKER_STREAM = 5
FRAME_COUNTERS = ("frames_decoded", "frames_returned")


def speakers_of(call_seed: int, rows: int,
                n_speakers: int) -> typing.List[int]:
    """The speaker of each row of the call with seed ``call_seed``."""
    r = textgen.rng(call_seed, SPEAKER_STREAM)
    return [int(s) for s in r.integers(0, n_speakers, rows)]


def _frames(session) -> typing.Optional[typing.Dict[str, int]]:
    """The session's frame counters, or None where it keeps none."""
    stats = session.stats
    if not all(hasattr(stats, k) for k in FRAME_COUNTERS):
        return None
    return {k: int(getattr(stats, k)) for k in FRAME_COUNTERS}


class _TracedFrames(_Traced):
    """:class:`.synth_batch._Traced` with the frame counters."""

    def __init__(self, session, ctx: Context):
        self.frames0 = _frames(session)
        super().__init__(session, ctx)

    def stop(self, start: float, utterances) -> None:
        super().stop(start, utterances)
        frames = _frames(self.session)
        if frames is not None and self.frames0 is not None:
            self.counters.update(
                {k: frames[k] - self.frames0[k] for k in FRAME_COUNTERS})


def run(ctx: Context) -> Outcome:
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    tr = ctx.traffic
    model = voice_config(ctx.config)["model"]
    n_speakers, hop = model["n_speakers"], hop_of(model)
    rate = ctx.config["audio"]["sample_rate"]
    common = dict(length_scale=tr["length_scale"],
                  noise_scale=tr["noise_scale"], noise_w=tr["noise_w"])

    def synthesize(ids, seed):
        who = speakers_of(seed, len(ids), n_speakers)
        return who, session.synthesize_ids_batch(ids, speaker_ids=who,
                                                 seed=seed, **common)

    t = time.perf_counter()
    voice_dir = spk.write_voice(ctx.workdir / "voice", ctx.config, ctx.seed,
                                ctx.device)
    written = time.perf_counter() - t
    voice = load_from_directory(voice_dir, device=str(ctx.device),
                                share_sessions=False)
    session = voice.session
    loaded = time.perf_counter() - t - written
    warm = calls(ctx, 1, model["num_symbols"])
    for _ in range(tr["warmup_calls"]):
        synthesize(*next(warm))
    _sync(ctx.device)
    print(f"set-up: voice written in {written:.3f} s, loaded in "
          f"{loaded:.3f} s, warmed in "
          f"{time.perf_counter() - t - written - loaded:.3f} s",
          file=sys.stderr)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)

    inputs = calls(ctx, 2, model["num_symbols"])
    pick = textgen.rng(ctx.seed, 3)
    kept: typing.List[typing.Tuple] = []
    longest = None
    utterances: typing.List[typing.Tuple[int, int]] = []
    hits0 = session.stats.hits_snapshot()
    traced = _TracedFrames(session, ctx) if ctx.trace else None
    start = time.perf_counter()
    deadline = start + ctx.seconds
    n, audio_s = 0, 0.0
    while True:
        ids, seed = next(inputs)
        who, out = synthesize(ids, seed)
        audio_s += sum(len(a) for a in out) / rate
        utterances += [(len(i), len(a) // hop) for i, a in zip(ids, out)]
        # reservoir sample of the calls, drawn from the seed
        slot = n if n < tr["check_calls"] else int(pick.integers(0, n + 1))
        if slot < tr["check_calls"]:
            if slot == len(kept):
                kept.append((ids, who, seed, out))
            else:
                kept[slot] = (ids, who, seed, out)
        row = int(np.argmax([len(a) for a in out]))
        if longest is None or len(out[row]) > len(longest[3]):
            longest = ([ids[row]], [who[row]], seed, [out[row]])
        n += 1
        now = time.perf_counter()
        if traced is not None and not traced.done and (
                now >= start + TRACE_SECONDS or now >= deadline):
            traced.stop(start, utterances)
        if now >= deadline:
            break
    window = time.perf_counter() - start
    print("window: speculation " + ", ".join(
        f"{k} {v}" for k, v in session.speculation.items()), file=sys.stderr)
    signatures = {k: v - hits0.get(k, 0)
                  for k, v in session.stats.hits_snapshot().items()
                  if v != hits0.get(k, 0)}
    if ctx.device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(ctx.device)
        name = torch.cuda.get_device_name(ctx.device)
    else:
        peak, name = 0, "cpu"
    del voice, session, out
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    answers = [spk.Answer(got=a, ids=i, seed=s, speaker=w, **common)
               for ids, who, s, out in kept + [longest]
               for i, w, a in zip(ids, who, out)]
    numbers = spk.judge(voice_dir, answers, ctx.device)
    return Outcome(
        end_to_end={"synth_audio_s_per_s": audio_s / window},
        first_call_at=start,
        artifacts=(traced.artifacts(model, name) if traced is not None
                   else Artifacts(model=model, window_s=window,
                                  device_name=name)),
        numbers={"length_bad": numbers["length_bad"],
                 "wave_err": numbers["wave_err"]},
        attempted=n * tr["rows"],
        failed=0,
        memory_peak_bytes=int(peak),
        signatures=signatures,
    )
