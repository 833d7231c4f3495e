"""The port's copies of the host modules against the JAX package's, on the
CPU: config parsing, phoneme-id encoding, SSML handling, the CLI's WAV and
the server's ``GET /api/voices``.  The port keeps its own copy of each
module (it imports nothing of ``mimic3_tpu``); these tests hold the copies
to the reference's behaviour.
"""

import asyncio
import dataclasses
import io
import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

from mimic3_tpu import config as ref_config
from mimic3_tpu import ssml as ref_ssml
from mimic3_tpu.server import __main__ as ref_server_main
from mimic3_tpu.server import app as ref_app
from mimic3_tpu.server.httpd import Request as RefRequest
from mimic3_tpu.text.phonemes2ids import phonemes2ids as ref_phonemes2ids
from mimic3_tpu_torch import config as port_config
from mimic3_tpu_torch import ssml as port_ssml
from mimic3_tpu_torch.runtime.testvoice import create_test_voice
from mimic3_tpu_torch.server import __main__ as port_server_main
from mimic3_tpu_torch.server import app as port_app
from mimic3_tpu_torch.server.httpd import Request as PortRequest
from mimic3_tpu_torch.text.phonemes2ids import (
    phonemes2ids as port_phonemes2ids,
)

REPO = Path(__file__).resolve().parents[1]
KEY = "en_US/tiny_low"


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    root = tmp_path_factory.mktemp("voices")
    create_test_voice(root / KEY, full_size=False)
    create_test_voice(root / "de_DE" / "multi_low", full_size=False,
                      n_speakers=3, seed=5)
    return root


def _normalized(value):
    """asdict output with enums as their values (the two packages have
    their own enum classes)."""
    if isinstance(value, dict):
        return {k: _normalized(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_normalized(v) for v in value]
    if hasattr(value, "value") and hasattr(type(value), "__members__"):
        return value.value
    return value


@pytest.mark.parametrize("voice", [KEY, "de_DE/multi_low"])
def test_config_parses_alike(voices, voice):
    path = voices / voice / "config.json"
    ref = ref_config.TrainingConfig.load_path(path)
    port = port_config.TrainingConfig.load_path(path)
    assert _normalized(dataclasses.asdict(port)) == _normalized(
        dataclasses.asdict(ref)
    )
    assert port.to_dict() == ref.to_dict()


_TABLE = {p: i for i, p in enumerate(
    ["_", "^", "$", "#", " ", ",", ".", "a", "b", "c", "ɛ", "ə", "t", "s",
     "1", "2", "3", "ˈ", "ŋ", "i"]
)}


@pytest.mark.parametrize(
    "words,kwargs",
    [
        ([["a", "b"], ["c", "."]], dict(blank="#", bos="^", eos="$")),
        ([["ɛ", "t"], ["s", "ə", ";"]],
         dict(blank="#", blank_between="tokens_and_words",
              simple_punctuation=True, auto_bos_eos=True, bos="^",
              eos="$")),
        ([["ˈa1", "ŋ"], ["i2", "b3"]],
         dict(separate_tones=True, blank="_", blank_word=" ",
              blank_between="tokens")),
        ([["a2", "t"], ["ˈɛ", "s1"]],
         dict(separate_tones=True, tone_before=True, blank="#",
              blank_at_start=False, blank_at_end=False,
              separate=["ˈ"])),
        ([["a", "x"], ["c"]],
         dict(blank="#", phoneme_map={"x": ["b", "c"]})),
    ],
)
def test_phonemes2ids_alike(words, kwargs):
    want = ref_phonemes2ids(words, _TABLE, **kwargs)
    got = port_phonemes2ids(words, _TABLE, **kwargs)
    assert got == want and want


class _Recorder:
    """A TextToSpeechSystem stand-in that records what the SSML speaker
    asks of it (calls and settings), in order."""

    def __init__(self):
        object.__setattr__(self, "log", [])
        object.__setattr__(self, "voice", "en_US/tiny_low")
        object.__setattr__(self, "language", "en_US")
        object.__setattr__(self, "speaker", None)
        object.__setattr__(self, "rate", 1.0)
        object.__setattr__(self, "volume", 100.0)

    def __setattr__(self, name, value):
        self.log.append(("set", name, repr(value)))
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        def call(*args, **kwargs):
            self.log.append((name, repr(args), repr(sorted(kwargs.items()))))
            return []

        return call


@pytest.mark.parametrize(
    "ssml",
    [
        "<speak>Hello there. <break time='250ms'/> General Kenobi.</speak>",
        "<speak><s>One</s><s><prosody rate='50%' volume='80'>two"
        "</prosody></s><mark name='m1'/><s>three</s></speak>",
        "<speak><voice name='de_DE/multi_low#2'><s xml:lang='de_DE'>"
        "Guten Tag</s></voice><say-as interpret-as='number'>42</say-as>"
        "<sub alias='World Wide Web'>WWW</sub></speak>",
        "<speak><p><w role='x'>read</w><phoneme ph='h ə l oʊ'>hello"
        "</phoneme></p><metadata>ignored</metadata> bare text</speak>",
        "plain text without markup",
    ],
)
def test_ssml_speaker_alike(ssml):
    ref, port = _Recorder(), _Recorder()
    ref_results = list(ref_ssml.SSMLSpeaker(ref).speak(ssml))
    port_results = list(port_ssml.SSMLSpeaker(port).speak(ssml))
    assert port.log == ref.log and ref.log
    assert [repr(r) for r in port_results] == [repr(r) for r in ref_results]


def test_cli_wav_matches_reference_cli(voices):
    """``--deterministic``: the port's CLI (on the CPU) writes a WAV of the
    reference CLI's length and format, correlation >= 0.999 (the
    end-to-end bar)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    text = b"Hello world. A second sentence, with a comma!\n"
    wavs = []
    for module, extra in (("mimic3_tpu.cli", []),
                          ("mimic3_tpu_torch.cli", ["--device", "cpu"])):
        proc = subprocess.run(
            [sys.executable, "-m", module, "--voices-dir", str(voices),
             "--voice", KEY, "--deterministic"] + extra,
            input=text, capture_output=True, env=env, timeout=600,
        )
        assert proc.returncode == 0, proc.stderr.decode()[-3000:]
        with wave.open(io.BytesIO(proc.stdout)) as w:
            assert (w.getframerate(), w.getsampwidth(),
                    w.getnchannels()) == (22050, 2, 1)
            wavs.append(np.frombuffer(w.readframes(w.getnframes()),
                                      np.int16).astype(np.float64))
    ref, port = wavs
    assert ref.size == port.size and ref.size > 0
    assert np.corrcoef(ref, port)[0, 1] >= 0.999


def test_api_voices_alike(voices):
    argv = ["--voices-dir", str(voices), "--cache-dir", str(voices / "c")]

    def voices_json(main_module, app_module, request_cls, **kw):
        args = main_module.build_arg_parser().parse_args(argv)
        app = app_module.TtsApp(main_module.config_from_args(args), **kw)
        try:
            server = app_module.build_server(app)
            handler, status = server._resolve(
                request_cls("GET", "/api/voices", {}, {})
            )
            assert status == 200
            reply = asyncio.run(handler(request_cls("GET", "/api/voices",
                                                    {}, {})))
            return json.loads(reply.body)
        finally:
            app.shutdown()

    want = voices_json(ref_server_main, ref_app, RefRequest)
    got = voices_json(port_server_main, port_app, PortRequest, device="cpu")
    assert got == want
    assert {v["key"] for v in got} >= {KEY, "de_DE/multi_low"}
