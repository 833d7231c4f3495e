"""Offline batch synthesis in process: a closed loop of back-to-back
``TorchVitsSession.synthesize_ids_batch`` calls.

Traffic parameters: ``rows`` x ``phonemes`` ids per call, drawn from the
seed over the voice's non-meta symbols; an explicit per-call seed from
the pool ``call_seeds``, each pass over it in an order drawn from the
seed (the duration noise follows the call seed, so every run gets the
same set of frame counts, and the seed does not change the work);
``length_scale``, ``noise_scale``, ``noise_w``; ``warmup_calls`` calls of
the same shape before the window (the mix's ``length_scale`` keeps every
row inside one frame bucket, so they warm the one decode the window
dispatches); ``check_calls`` calls kept (a reservoir drawn from the
seed) whose rows, with the window's longest row, the reference judges.

End-to-end: ``synth_audio_s_per_s``, the audio-seconds every call of the
window returned over the window's wall seconds.  Counters for the
per-layer readers: the session's speculation counts and its dispatched
signatures, diffed across the traced window.  The result line lists the
signatures the whole window dispatched.
"""

from __future__ import annotations

import gc
import sys
import time
import typing

import numpy as np
import torch

from .. import check, textgen
from .. import trace as tracing
from ..counts import hop as hop_of
from ..harness import TRACE_SECONDS, Artifacts, Context, Outcome
from ..voice import voice_config, write_voice

META_SYMBOLS = 4


def calls(ctx: Context, stream: int, num_symbols: int):
    """(ids, call seed) of each call: the ids from the run's seed, the
    call seeds from the mix's fixed pool in an order of the run's own."""
    tr = ctx.traffic
    r = textgen.rng(ctx.seed, stream)
    while True:
        for seed in r.permutation(tr["call_seeds"]):
            ids = r.integers(META_SYMBOLS, num_symbols,
                             (tr["rows"], tr["phonemes"]))
            yield [list(map(int, row)) for row in ids], int(seed)


def _synthesize(session, tr, ids, seed):
    return session.synthesize_ids_batch(
        ids, length_scale=tr["length_scale"], noise_scale=tr["noise_scale"],
        noise_w=tr["noise_w"], seed=seed)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Traced:
    """The profiler over the first ``TRACE_SECONDS`` of the window, and
    the session's counters diffed across the same calls."""

    def __init__(self, session, ctx: Context):
        from torch.profiler import ProfilerActivity, profile

        self.session, self.ctx = session, ctx
        self.spec0 = dict(session.speculation)
        self.hits0 = session.stats.hits_snapshot()
        activities = [ProfilerActivity.CPU]
        if ctx.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.done = False

    def stop(self, start: float, utterances) -> None:
        self.window = time.perf_counter() - start
        self.prof.stop()  # seconds of the profiler's own work: not traced
        self.utterances = list(utterances)
        spec, hits = self.session.speculation, \
            self.session.stats.hits_snapshot()
        self.counters = {
            "spec_used": spec["used"] - self.spec0["used"],
            "spec_fell_back": spec["fell_back"] - self.spec0["fell_back"],
            "spec_skipped": spec["skipped"] - self.spec0["skipped"],
            "hits": {k: v - self.hits0.get(k, 0) for k, v in hits.items()
                     if v != self.hits0.get(k, 0)},
        }
        print("traced window: speculation " + ", ".join(
            f"{k} {spec[k] - self.spec0[k]}" for k in spec), file=sys.stderr)
        path = self.ctx.workdir / "trace.json"
        self.prof.export_chrome_trace(str(path))
        del self.prof
        self.trace = tracing.load(path, self.window)
        path.unlink()
        self.done = True

    def artifacts(self, model, device_name: str) -> Artifacts:
        return Artifacts(model=model, window_s=self.window,
                         device_name=device_name, trace=self.trace,
                         counters=self.counters,
                         utterances=self.utterances)


def run(ctx: Context) -> Outcome:
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    tr = ctx.traffic
    model = voice_config(ctx.config)["model"]
    hop = hop_of(model)
    rate = ctx.config["audio"]["sample_rate"]
    t = time.perf_counter()
    voice_dir = write_voice(ctx.workdir / "voice", ctx.config, ctx.seed,
                            ctx.device)
    written = time.perf_counter() - t
    voice = load_from_directory(voice_dir, device=str(ctx.device),
                                share_sessions=False)
    session = voice.session
    loaded = time.perf_counter() - t - written
    warm = calls(ctx, 1, model["num_symbols"])
    for _ in range(tr["warmup_calls"]):
        _synthesize(session, tr, *next(warm))
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
    traced = _Traced(session, ctx) if ctx.trace else None
    start = time.perf_counter()
    deadline = start + ctx.seconds
    n, audio_s = 0, 0.0
    while True:
        ids, seed = next(inputs)
        out = _synthesize(session, tr, ids, seed)
        audio_s += sum(len(a) for a in out) / rate
        utterances += [(len(i), len(a) // hop) for i, a in zip(ids, out)]
        # reservoir sample of the calls, drawn from the seed
        slot = n if n < tr["check_calls"] else int(pick.integers(0, n + 1))
        if slot < tr["check_calls"]:
            if slot == len(kept):
                kept.append((ids, seed, out))
            else:
                kept[slot] = (ids, seed, out)
        row = int(np.argmax([len(a) for a in out]))
        if longest is None or len(out[row]) > len(longest[2]):
            longest = (ids[row], seed, out[row])
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

    answers = [
        check.Answer(got=a, ids=i, seed=s, length_scale=tr["length_scale"],
                     noise_scale=tr["noise_scale"], noise_w=tr["noise_w"])
        for ids, s, out in kept for i, a in zip(ids, out)
    ]
    ids, s, a = longest
    answers.append(check.Answer(got=a, ids=ids, seed=s,
                                length_scale=tr["length_scale"],
                                noise_scale=tr["noise_scale"],
                                noise_w=tr["noise_w"]))
    numbers = check.judge(voice_dir, answers, ctx.device)
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
