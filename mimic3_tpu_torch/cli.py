"""``mimic3`` command-line interface.

Flag-compatible with the reference CLI (reference:
mimic3_tts/__main__.py:595-720): stdin/arg text, SSML documents, CSV
``id|text`` / ``id|voice|text`` input, per-line voice switching,
interactive playback, WAV output dirs with text/time/id naming, mark
files, combined WAV to stdout, remote-server client mode, deterministic
synthesis and seeding.

Synthesis runs on PyTorch via the engine, on ``--device {cuda,cpu}``
(default ``cuda``; with no card visible it raises, the CPU is used only
when named); audio post-processing and playback happen on a consumer
thread so the device is never idle waiting on IO.

    echo 'Hello.' | python -m mimic3_tpu_torch.cli --voice <voice> > out.wav

Port copy of ``mimic3_tpu/cli.py`` with ``--device`` among its flags.
"""

from __future__ import annotations

import argparse
import csv
import io
import logging
import os
import shlex
import shutil
import string
import subprocess
import sys
import tempfile
import threading
import time
import typing
import wave
from dataclasses import dataclass
from enum import Enum
from pathlib import Path
from queue import Queue

_LOGGER = logging.getLogger(__name__)

_DEFAULT_PLAY_PROGRAMS = [
    "paplay",
    "play -q",
    "aplay -q",
    "mpv --no-terminal",
    "mplayer",
]


class OutputNaming(str, Enum):
    TEXT = "text"
    TIME = "time"
    ID = "id"


class StdinFormat(str, Enum):
    AUTO = "auto"
    LINES = "lines"
    DOCUMENT = "document"


@dataclass
class _QueuedResult:
    result: typing.Any
    line: str
    line_id: str = ""


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="mimic3",
        description="mimic3-tpu on PyTorch: text to speech",
    )
    parser.add_argument(
        "text", nargs="*", help="Text to speak (default: stdin)"
    )
    parser.add_argument(
        "--remote",
        nargs="?",
        const="http://localhost:59125",
        help="Use a running mimic3-server for synthesis",
    )
    parser.add_argument(
        "--stdin-format",
        choices=[v.value for v in StdinFormat],
        default=StdinFormat.AUTO.value,
        help="Format of stdin text (default: auto)",
    )
    parser.add_argument(
        "--voice", "-v", help="Voice key (<language>/<name>[#speaker])"
    )
    parser.add_argument(
        "--speaker", "-s", help="Speaker name or id (default: first)"
    )
    parser.add_argument(
        "--voices-dir",
        action="append",
        help="Extra directory with <language>/<voice> dirs",
    )
    parser.add_argument(
        "--voices", action="store_true", help="List voices and exit"
    )
    parser.add_argument("--output-dir", help="Write WAV file(s) here")
    parser.add_argument(
        "--output-naming",
        choices=[v.value for v in OutputNaming],
        default=OutputNaming.TEXT.value,
        help="WAV file naming with --output-dir (default: text)",
    )
    parser.add_argument(
        "--id-delimiter",
        default="|",
        help="Delimiter between id and text (default: |)",
    )
    parser.add_argument(
        "--interactive",
        action="store_true",
        help="Play audio after each line",
    )
    parser.add_argument(
        "--csv", action="store_true", help="Input lines are id|text"
    )
    parser.add_argument(
        "--csv-delimiter", default="|", help="--csv delimiter (default: |)"
    )
    parser.add_argument(
        "--csv-voice",
        action="store_true",
        help="Input lines are id|voice|text or id|#speaker|text",
    )
    parser.add_argument(
        "--mark-file", help="Write SSML <mark> names here (one per line)"
    )
    parser.add_argument(
        "--noise-scale", type=float, help="Audio noise [0-1] (default 0.667)"
    )
    parser.add_argument(
        "--length-scale",
        type=float,
        help="Phoneme length multiplier (1.0 = normal, 0.5 = 2x faster)",
    )
    parser.add_argument(
        "--noise-w", type=float, help="Cadence noise [0-1] (default 0.8)"
    )
    parser.add_argument(
        "--result-queue-size",
        type=int,
        default=5,
        help="Max pending output sentences (default: 5)",
    )
    parser.add_argument(
        "--process-on-blank-line",
        action="store_true",
        help="Accumulate lines; synthesize on blank lines",
    )
    parser.add_argument(
        "--ssml", action="store_true", help="Input is SSML"
    )
    parser.add_argument(
        "--stdout",
        action="store_true",
        help="Write audio to stdout even on a tty",
    )
    parser.add_argument(
        "--preload-voice", action="append", help="Preload voice at startup"
    )
    parser.add_argument(
        "--play-program",
        action="append",
        default=list(_DEFAULT_PLAY_PROGRAMS),
        help="Program(s) used to play WAV files",
    )
    parser.add_argument(
        "--cuda",
        action="store_true",
        help="(compat; ignored — the device is --device)",
    )
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="Torch device to synthesize on (cuda raises without a card)",
    )
    parser.add_argument(
        "--deterministic",
        action="store_true",
        help="Identical audio for identical input (disables noise)",
    )
    parser.add_argument("--seed", type=int, help="Random seed")
    parser.add_argument(
        "--no-download",
        action="store_true",
        help="Never download voices automatically",
    )
    parser.add_argument(
        "--version", action="store_true", help="Print version and exit"
    )
    parser.add_argument(
        "--debug", action="store_true", help="DEBUG logging"
    )
    return parser


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO
    )

    if args.version:
        from . import __version__

        print(__version__)
        return 0

    if args.cuda:
        _LOGGER.warning("--cuda is ignored: synthesis runs on --device")

    # -- normalize args (reference: mimic3_tts/__main__.py:134-228) --------
    if args.csv_voice:
        args.csv = True
    if args.csv:
        args.output_naming = OutputNaming.ID.value
    elif args.ssml:
        args.output_naming = OutputNaming.TIME.value
    if args.deterministic:
        args.noise_scale = 0.0
        args.noise_w = 0.0
    if args.remote:
        args.remote = args.remote.rstrip("/")
    if (not args.speaker) and args.voice and ("#" in args.voice):
        args.voice, args.speaker = args.voice.split("#", maxsplit=1)

    output_dir: typing.Optional[Path] = None
    if args.output_dir:
        output_dir = Path(args.output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    mark_writer: typing.TextIO
    if args.mark_file and args.mark_file != "-":
        mark_path = Path(args.mark_file)
        mark_path.parent.mkdir(parents=True, exist_ok=True)
        mark_writer = open(mark_path, "w", encoding="utf-8")
    elif args.stdout:
        mark_writer = sys.stderr
    else:
        mark_writer = sys.stdout

    # -- TTS / remote client ------------------------------------------------
    tts = None
    if not args.remote:
        from .engine import Mimic3Settings, Mimic3TextToSpeechSystem

        tts = Mimic3TextToSpeechSystem(
            Mimic3Settings(
                length_scale=args.length_scale,
                noise_scale=args.noise_scale,
                noise_w=args.noise_w,
                voices_directories=args.voices_dir,
                use_deterministic_compute=args.deterministic,
                seed=args.seed,
                no_download=args.no_download,
            ),
            device=args.device,
        )
        if args.voice:
            tts.voice = args.voice
        if args.speaker:
            tts.speaker = args.speaker
        for key in args.preload_voice or []:
            tts.preload_voice(key)

    if args.voices:
        _print_voices(tts, args)
        return 0

    # -- input text -----------------------------------------------------------
    if args.text:
        texts: typing.Iterable[str] = args.text
    else:
        if os.isatty(sys.stdin.fileno()):
            print("Reading text from stdin...", file=sys.stderr)
        stdin_format = args.stdin_format
        if stdin_format == StdinFormat.AUTO.value:
            stdin_format = (
                StdinFormat.DOCUMENT.value
                if args.ssml
                else StdinFormat.LINES.value
            )
        if stdin_format == StdinFormat.DOCUMENT.value:
            texts = [sys.stdin.read()]
        else:
            texts = sys.stdin

    if args.process_on_blank_line:
        texts = _group_on_blank_lines(texts)

    # -- consumer thread ----------------------------------------------------------
    combined = {
        "audio": bytearray(),
        "rate": 22050,
        "width": 2,
        "channels": 1,
    }
    result_queue: "Queue[typing.Optional[_QueuedResult]]" = Queue(
        maxsize=args.result_queue_size
    )
    consumer = threading.Thread(
        target=_consume_results,
        daemon=True,
        args=(result_queue, args, output_dir, mark_writer, combined),
    )
    consumer.start()

    # -- main loop -------------------------------------------------------------------
    try:
        for line in texts:
            line = line.strip()
            if not line:
                continue
            line_id = ""
            line_voice = None
            if args.output_naming == OutputNaming.ID.value:
                row = next(
                    csv.reader(io.StringIO(line), delimiter=args.csv_delimiter)
                )
                line_id, line = row[0], row[-1]
                if args.csv_voice:
                    line_voice = row[1]
            _speak_line(
                tts, args, line, line_id, line_voice, result_queue
            )
    except KeyboardInterrupt:
        while not result_queue.empty():
            result_queue.get()
    finally:
        result_queue.put(None)
        consumer.join()
        if tts is not None:
            tts.shutdown()

    # -- combined WAV output ------------------------------------------------------------
    if combined["audio"]:
        if sys.stdout.isatty() and not args.stdout:
            with io.BytesIO() as wav_io:
                _write_wav(wav_io, combined)
                play_wav_bytes(args, wav_io.getvalue())
        else:
            _write_wav(sys.stdout.buffer, combined)
            sys.stdout.buffer.flush()
    return 0


def _group_on_blank_lines(
    lines: typing.Iterable[str],
) -> typing.Iterator[str]:
    """Accumulate book-style wrapped lines until a blank line."""
    text = ""
    for line in lines:
        line = line.strip()
        if not line:
            if text:
                yield text
            text = ""
            continue
        text += " " + line
    if text:
        yield text


def _speak_line(
    tts,
    args,
    line: str,
    line_id: str,
    line_voice: typing.Optional[str],
    result_queue: Queue,
) -> None:
    from .api import AudioResult

    if tts is not None:
        if line_voice:
            if line_voice.startswith("#"):
                tts.speaker = line_voice[1:]
            else:
                tts.voice = line_voice
        if args.ssml:
            from .ssml import SSMLSpeaker

            results = SSMLSpeaker(tts).speak(line)
        else:
            tts.begin_utterance()
            tts.speak_text(line)
            results = tts.end_utterance()
    else:
        voice = None
        if line_voice:
            voice = (
                f"{args.voice}{line_voice}"
                if line_voice.startswith("#") and args.voice
                else line_voice
            )
        wav_bytes = _remote_wav(args, line, voice)
        with wave.open(io.BytesIO(wav_bytes), "rb") as wav_file:
            results = [
                AudioResult(
                    sample_rate_hz=wav_file.getframerate(),
                    sample_width_bytes=wav_file.getsampwidth(),
                    num_channels=wav_file.getnchannels(),
                    audio_bytes=wav_file.readframes(
                        wav_file.getnframes()
                    ),
                )
            ]

    for result in results:
        result_queue.put(_QueuedResult(result, line, line_id))

    if tts is not None:
        # restore per-run defaults after a per-line override
        tts.voice = args.voice
        tts.speaker = args.speaker


def _consume_results(
    result_queue: Queue,
    args,
    output_dir: typing.Optional[Path],
    mark_writer: typing.TextIO,
    combined: dict,
) -> None:
    from .api import AudioResult, MarkResult

    while True:
        item = result_queue.get()
        if item is None:
            return
        try:
            result = item.result
            if isinstance(result, AudioResult):
                wav_bytes: typing.Optional[bytes] = None
                if args.interactive:
                    if args.stdout:
                        sys.stdout.buffer.write(result.audio_bytes)
                        sys.stdout.buffer.flush()
                    else:
                        wav_bytes = result.to_wav_bytes()
                        play_wav_bytes(args, wav_bytes)
                if output_dir is not None:
                    wav_bytes = wav_bytes or result.to_wav_bytes()
                    name = _output_file_name(args, item)
                    (output_dir / f"{name}.wav").write_bytes(wav_bytes)
                if not args.interactive and output_dir is None:
                    combined["audio"] += result.audio_bytes
                    combined["rate"] = result.sample_rate_hz
                    combined["width"] = result.sample_width_bytes
                    combined["channels"] = result.num_channels
            elif isinstance(result, MarkResult):
                print(result.name, file=mark_writer, flush=True)
        except Exception:
            _LOGGER.exception("Error processing result")


def _output_file_name(args, item: _QueuedResult) -> str:
    if args.output_naming == OutputNaming.TEXT.value:
        name = item.line.strip().replace(" ", "_")
        return name.translate(
            str.maketrans("", "", string.punctuation.replace("_", ""))
        )
    if args.output_naming == OutputNaming.TIME.value:
        return str(time.time())
    return item.line_id or "output"


def _write_wav(fp, combined: dict) -> None:
    with wave.open(fp, "wb") as wav_file:
        wav_file.setframerate(combined["rate"])
        wav_file.setsampwidth(combined["width"])
        wav_file.setnchannels(combined["channels"])
        wav_file.writeframes(bytes(combined["audio"]))


def play_wav_bytes(args, wav_bytes: bytes) -> None:
    """Play WAV audio via the first available player program."""
    with tempfile.NamedTemporaryFile(mode="wb+", suffix=".wav") as f:
        f.write(wav_bytes)
        f.seek(0)
        for program in reversed(args.play_program):
            cmd = shlex.split(program)
            if not shutil.which(cmd[0]):
                continue
            cmd.append(f.name)
            _LOGGER.debug("Playing: %s", cmd)
            subprocess.check_output(cmd)
            break
        else:
            _LOGGER.warning("No audio player found (tried %s)",
                            args.play_program)


def _print_voices(tts, args) -> None:
    if tts is not None:
        voices = sorted(tts.get_voices(), key=lambda v: v.key)
    else:
        voices = _remote_voices(args)
    writer = csv.writer(sys.stdout, delimiter="\t")
    writer.writerow(("KEY", "LANGUAGE", "NAME", "DESCRIPTION", "LOCATION"))
    for voice in voices:
        writer.writerow(
            (
                voice.key,
                voice.language,
                voice.name,
                voice.description,
                voice.location,
            )
        )


# -- remote client (stdlib urllib; no requests dependency) -------------------


def _remote_voices(args) -> typing.List:
    import json
    import urllib.request

    from .api import Voice

    url = f"{args.remote}/api/voices"
    with urllib.request.urlopen(url) as response:
        voices_json = json.load(response)
    out = []
    for voice_args in voices_json:
        known = {
            k: v
            for k, v in voice_args.items()
            if k in Voice.__dataclass_fields__
        }
        if known.get("aliases") is not None:
            known["aliases"] = set(known["aliases"])
        out.append(Voice(**known))
    return out


def _remote_wav(args, text: str, voice: typing.Optional[str]) -> bytes:
    import urllib.parse
    import urllib.request

    params: typing.Dict[str, str] = {}
    if voice:
        params["voice"] = voice
    elif args.voice:
        params["voice"] = (
            f"{args.voice}#{args.speaker}" if args.speaker else args.voice
        )
    if args.length_scale is not None:
        params["lengthScale"] = str(args.length_scale)
    if args.noise_scale is not None:
        params["noiseScale"] = str(args.noise_scale)
    if args.noise_w is not None:
        params["noiseW"] = str(args.noise_w)

    content_type = (
        "application/ssml+xml" if args.ssml else "text/plain"
    )
    url = f"{args.remote}/api/tts"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    request = urllib.request.Request(
        url,
        data=text.encode("utf-8"),
        headers={"Content-Type": content_type},
        method="POST",
    )
    with urllib.request.urlopen(request) as response:
        return response.read()


if __name__ == "__main__":
    raise SystemExit(main())
