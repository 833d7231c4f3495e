"""Voice downloader: versioned, sha256-verified fetch of voice directories.

Wire-compatible with the mimic3-voices layout and URL scheme
(reference: mimic3_tts/download.py:69-142): each voice file is fetched
from ``<url_base>/<relative_path>``, skipped when an existing file's
sha256 already matches, and the whole voice is re-fetched when the
registry's version is later than the local ``VERSION`` file.

Port copy of ``mimic3_tpu/download.py``.
"""

from __future__ import annotations

import itertools
import logging
import os
import typing
import urllib.request
from dataclasses import dataclass
from pathlib import Path

from .utils import file_sha256_sum
from .voices_registry import get_voices_registry, registry_url_template

_LOGGER = logging.getLogger(__name__)


def default_voices_download_dir() -> Path:
    """XDG data home voices dir (same location the reference uses, so
    already-downloaded Mimic 3 voices are picked up unchanged)."""
    data_home = os.environ.get(
        "XDG_DATA_HOME", str(Path.home() / ".local" / "share")
    )
    return Path(data_home) / "mycroft" / "mimic3" / "voices"


class VoiceDownloadError(Exception):
    """A voice could not be downloaded."""


@dataclass
class VoiceFile:
    relative_path: str
    size_bytes: typing.Optional[int] = None
    sha256_sum: typing.Optional[str] = None


def is_later_version(version1: str, version2: str) -> bool:
    """Dotted-version comparison: True when version1 > version2."""
    try:
        v1 = [int(n) for n in version1.split(".")]
        v2 = [int(n) for n in version2.split(".")]
    except ValueError:
        return version1 > version2
    for p1, p2 in itertools.zip_longest(v1, v2, fillvalue=0):
        if p1 != p2:
            return p1 > p2
    return False


def download_voice(
    voice_key: str,
    url_base: str,
    voice_files: typing.Iterable[VoiceFile],
    voice_version: typing.Optional[str],
    voices_dir: typing.Optional[typing.Union[str, Path]] = None,
    chunk_bytes: int = 65536,
    redownload: bool = False,
    progress: bool = True,
) -> Path:
    """Download all files of a voice; returns the voice directory."""
    url_base = url_base.rstrip("/")
    voices_dir = Path(voices_dir or default_voices_download_dir())
    voice_dir = voices_dir / voice_key
    voice_dir.mkdir(parents=True, exist_ok=True)

    version_path = voice_dir / "VERSION"
    if voice_version and version_path.is_file():
        local_version = version_path.read_text(encoding="utf-8").strip()
        if is_later_version(voice_version, local_version):
            _LOGGER.info(
                "Upgrading %s: %s -> %s",
                voice_key,
                local_version,
                voice_version,
            )
            redownload = True

    for voice_file in voice_files:
        file_url = f"{url_base}/{voice_file.relative_path}"
        file_path = voice_dir / voice_file.relative_path
        file_path.parent.mkdir(parents=True, exist_ok=True)

        if (
            (not redownload)
            and voice_file.sha256_sum
            and file_path.is_file()
        ):
            with open(file_path, "rb") as f:
                if file_sha256_sum(f) == voice_file.sha256_sum:
                    _LOGGER.debug(
                        "%s already downloaded (sha256 match)", file_path
                    )
                    continue

        _LOGGER.info("Downloading %s", file_url)
        try:
            _fetch(file_url, file_path, chunk_bytes, progress)
        except Exception as e:
            raise VoiceDownloadError(
                f"Failed to download {file_url}: {e}"
            ) from e

        if voice_file.sha256_sum:
            with open(file_path, "rb") as f:
                actual = file_sha256_sum(f)
            if actual != voice_file.sha256_sum:
                file_path.unlink(missing_ok=True)
                raise VoiceDownloadError(
                    f"sha256 mismatch for {file_url}: "
                    f"expected {voice_file.sha256_sum}, got {actual}"
                )

    return voice_dir


def _fetch(
    url: str, dest: Path, chunk_bytes: int, progress: bool
) -> None:
    bar = None
    if progress:
        try:
            from tqdm.auto import tqdm

            bar = tqdm(
                unit="B", unit_scale=True, desc=dest.name, leave=False
            )
        except ImportError:
            bar = None
    tmp = dest.with_suffix(dest.suffix + ".part")
    try:
        with urllib.request.urlopen(url) as response:
            total = response.headers.get("Content-Length")
            if bar is not None and total:
                bar.total = int(total)
            with open(tmp, "wb") as out:
                while True:
                    chunk = response.read(chunk_bytes)
                    if not chunk:
                        break
                    out.write(chunk)
                    if bar is not None:
                        bar.update(len(chunk))
        tmp.replace(dest)
    finally:
        tmp.unlink(missing_ok=True)
        if bar is not None:
            bar.close()


def is_voice_downloaded(
    voice_key: str,
    voices_dir: typing.Optional[typing.Union[str, Path]] = None,
    verify_hashes: bool = True,
) -> bool:
    """True when every registry file of the voice is present and valid.

    ``verify_hashes=False`` checks presence + size only — enough for
    listings; full sha256 verification (the default) belongs on the
    download/skip path, where it decides whether to re-fetch.
    """
    info = get_voices_registry().get(voice_key)
    if info is None:
        return False
    voice_dir = Path(voices_dir or default_voices_download_dir()) / voice_key
    for rel_path, file_info in info["files"].items():
        path = voice_dir / rel_path
        if not path.is_file():
            return False
        expected_size = file_info.get("size_bytes")
        if expected_size and path.stat().st_size != expected_size:
            return False
        if not verify_hashes:
            continue
        expected = file_info.get("sha256_sum")
        if expected:
            with open(path, "rb") as f:
                if file_sha256_sum(f) != expected:
                    return False
    return True


def download_voice_by_key(
    voice_key: str,
    voices_dir: typing.Optional[typing.Union[str, Path]] = None,
    url_format: typing.Optional[str] = None,
    redownload: bool = False,
) -> Path:
    """Download a registry voice by its key.

    ``url_format`` defaults to the registry's own url_template.
    """
    if url_format is None:
        url_format = registry_url_template()
    info = get_voices_registry().get(voice_key)
    if info is None:
        raise VoiceDownloadError(f"Voice not in registry: {voice_key}")
    lang, name = voice_key.split("/", maxsplit=1)
    url_base = url_format.format(key=voice_key, lang=lang, name=name)
    files = [
        VoiceFile(p, f.get("size_bytes"), f.get("sha256_sum"))
        for p, f in info["files"].items()
    ]
    return download_voice(
        voice_key,
        url_base,
        files,
        info.get("version"),
        voices_dir=voices_dir,
        redownload=redownload,
    )
