"""``mimic3-torch-download`` against the reference's ``mimic3-download``.

No network: a fake registry entry whose files are served from a local
``file://`` URL (the setup of ``tests/test_download.py``), added to both
packages' registries.  Both CLIs download it, by key and by wildcard,
and list the catalog; their outputs must be the same.
"""

import hashlib

import pytest

from mimic3_tpu import download_cli as ref_cli
from mimic3_tpu.voices_registry import get_voices_registry as ref_registry
from mimic3_tpu_torch import download_cli as port_cli
from mimic3_tpu_torch.voices_registry import (
    get_voices_registry as port_registry,
)

KEY = "xx_XX/fake_low"


@pytest.fixture
def remote(tmp_path, monkeypatch):
    """A voice served from a file:// URL and listed in both registries;
    returns the URL format."""
    src = tmp_path / "remote" / "xx_XX" / "fake_low"
    src.mkdir(parents=True)
    payload = b"fake model data"
    (src / "generator.onnx").write_bytes(payload)
    (src / "config.json").write_bytes(b"{}")
    entry = {
        "version": "1.0",
        "aliases": [],
        "speakers": [],
        "properties": {},
        "files": {
            "generator.onnx": {
                "size_bytes": len(payload),
                "sha256_sum": hashlib.sha256(payload).hexdigest(),
            },
            "config.json": {"size_bytes": 2, "sha256_sum": None},
        },
    }
    for registry in (ref_registry(), port_registry()):
        monkeypatch.setitem(registry, KEY, entry)
    return f"file://{tmp_path / 'remote'}/{{lang}}/{{name}}", payload


def _run(cli, argv, capsys):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("pattern", [KEY, "xx_XX/*"])
def test_download_prints_what_the_reference_prints(
    remote, pattern, tmp_path, capsys
):
    url_format, payload = remote
    outputs = []
    for name, cli in (("ref", ref_cli), ("port", port_cli)):
        out_dir = tmp_path / name
        rc, out = _run(
            cli,
            [pattern, "--output-dir", str(out_dir), "--url-format",
             url_format],
            capsys,
        )
        assert rc == 0
        assert (out_dir / KEY / "generator.onnx").read_bytes() == payload
        outputs.append(out.replace(str(out_dir), "<dir>"))
        # listing: the catalog with the fake voice marked downloaded
        rc, listing = _run(cli, ["--list", "--output-dir", str(out_dir)],
                           capsys)
        assert rc == 0 and f"{KEY} [downloaded]" in listing
        outputs.append(listing)
    assert outputs[2] == outputs[0] == f"{KEY}\t<dir>/{KEY}\n"
    assert outputs[3] == outputs[1]


def test_failed_download_exits_like_the_reference(remote, tmp_path, capsys):
    url_format, _ = remote
    bad = url_format.replace("remote", "missing")
    rcs = [
        cli.main([KEY, "--output-dir", str(tmp_path / name),
                  "--url-format", bad])
        for name, cli in (("ref", ref_cli), ("port", port_cli))
    ]
    assert rcs == [1, 1]
