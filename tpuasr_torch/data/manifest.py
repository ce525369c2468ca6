"""Manifest IO (a copy of ``tpuasr/data/manifest.py``'s reader, writer
and ordering; numpy and scipy only).

One ``wav_path,transcript_path[,duration]`` line per utterance; the
optional duration column spares re-reading WAV headers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from tpuasr_torch.audio.io import duration_seconds


@dataclass(frozen=True)
class ManifestEntry:
    wav_path: str
    transcript_path: str
    duration: float | None = None

    def read_transcript(self) -> str:
        with open(self.transcript_path, "r", encoding="utf-8") as f:
            return f.read().strip()


def read_manifest(path: str) -> list[ManifestEntry]:
    entries = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if len(parts) == 2:
                entries.append(ManifestEntry(parts[0], parts[1]))
            else:
                entries.append(ManifestEntry(parts[0], parts[1], float(parts[2])))
    return entries


def write_manifest(path: str, entries: list[ManifestEntry]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for e in entries:
            if e.duration is None:
                f.write(f"{e.wav_path},{e.transcript_path}\n")
            else:
                f.write(f"{e.wav_path},{e.transcript_path},{e.duration:.4f}\n")


def with_durations(entries: list[ManifestEntry]) -> list[ManifestEntry]:
    out = []
    for e in entries:
        d = e.duration if e.duration is not None else duration_seconds(e.wav_path)
        out.append(ManifestEntry(e.wav_path, e.transcript_path, d))
    return out


def order_and_prune(entries: list[ManifestEntry], min_duration: float | None = None,
                    max_duration: float | None = None) -> list[ManifestEntry]:
    """Duration-sort and min/max filtering (what SortaGrad and the
    bucketing rely on)."""
    entries = with_durations(entries)
    if min_duration is not None:
        entries = [e for e in entries if e.duration >= min_duration]
    if max_duration is not None:
        entries = [e for e in entries if e.duration <= max_duration]
    return sorted(entries, key=lambda e: e.duration)
