"""Manifest IO and tools (a copy of ``tpuasr/data/manifest.py``; numpy
and scipy only).

One ``wav_path,transcript_path[,duration]`` line per utterance; the
optional duration column spares re-reading WAV headers. The tools are
the reference's ``data/utils.py`` and ``data/merge_manifests.py``:
``create_manifest`` (scan a corpus directory), ``order_and_prune``
(duration sort and min/max filtering, what SortaGrad and the bucketing
rely on) and ``merge_manifests``.

Usage:
  python -m tpuasr_torch.data.manifest create <corpus_dir> <manifest>
  python -m tpuasr_torch.data.manifest merge a.csv b.csv --out all.csv
  python -m tpuasr_torch.data.manifest prune m.csv --out p.csv \
      [--min-duration 1 --max-duration 15]
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from pathlib import Path

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


def create_manifest(corpus_dir: str, manifest_path: str, wav_suffix: str = ".wav",
                    txt_suffix: str = ".txt", ordered: bool = True) -> list[ManifestEntry]:
    """Scan ``corpus_dir`` for wav/transcript pairs (matching stems) and
    write a duration-annotated manifest."""
    entries = []
    for wav in sorted(Path(corpus_dir).rglob(f"*{wav_suffix}")):
        txt = wav.with_suffix(txt_suffix)
        if txt.exists():
            entries.append(ManifestEntry(str(wav), str(txt)))
    entries = with_durations(entries)
    if ordered:
        entries.sort(key=lambda e: e.duration)
    write_manifest(manifest_path, entries)
    return entries


def merge_manifests(paths: list[str], out_path: str,
                    ordered: bool = True) -> list[ManifestEntry]:
    entries: list[ManifestEntry] = []
    for p in paths:
        entries.extend(read_manifest(p))
    entries = with_durations(entries)
    if ordered:
        entries.sort(key=lambda e: e.duration)
    write_manifest(out_path, entries)
    return entries


def main(argv=None) -> int:
    """The manifest tools: create | merge | prune."""
    p = argparse.ArgumentParser(description="tpuasr manifest tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create", help="scan a corpus dir for wav/txt pairs")
    c.add_argument("corpus_dir")
    c.add_argument("manifest")
    c.add_argument("--wav-suffix", default=".wav")
    c.add_argument("--txt-suffix", default=".txt")

    m = sub.add_parser("merge", help="merge manifests, duration-sorted")
    m.add_argument("manifests", nargs="+")
    m.add_argument("--out", required=True)

    r = sub.add_parser("prune", help="filter by min/max duration + sort")
    r.add_argument("manifest")
    r.add_argument("--out", required=True)
    r.add_argument("--min-duration", type=float, default=None)
    r.add_argument("--max-duration", type=float, default=None)

    args = p.parse_args(argv)
    if args.cmd == "create":
        out = create_manifest(args.corpus_dir, args.manifest, args.wav_suffix,
                              args.txt_suffix)
        print(f"{len(out)} entries -> {args.manifest}")
    elif args.cmd == "merge":
        out = merge_manifests(args.manifests, args.out)
        print(f"{len(out)} entries -> {args.out}")
    else:
        out = order_and_prune(read_manifest(args.manifest), args.min_duration,
                              args.max_duration)
        write_manifest(args.out, out)
        print(f"{len(out)} entries -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
