"""PT-BR corpus preparation (a copy of ``tpuasr/data/corpus.py`` on the
port's ``audio/io.py`` and ``data/manifest.py``; numpy and scipy only).

The reference's per-corpus prep scripts (its fork's main delta from
upstream deepspeech.pytorch): acquire CETUC, LapsBM, VoxForge-PT, Sid
or CSLU Spoltech, resample to 16 kHz mono WAV, write one transcript
``.txt`` per utterance, and emit duration-sorted manifests.
``fetch_corpus`` takes a directory, a local archive, or an
``http(s)://``/``file://`` URL of an archive.

Layouts handled (each prepare_* parses its corpus's documented layout
and falls back to the generic pair scan when the layout markers are
absent):
  * LapsBM (LapsBM1.4): speaker dirs ``LapsBM-F###`` / ``LapsBM-M###``,
    each holding paired ``*.wav`` + ``*.txt`` per utterance; stems keep
    the speaker id so train/test splits by speaker stay possible.
  * CETUC ("alcaim"): one dir per speaker, each with paired wav/txt
    (the same ~1000 prompt sentences per speaker).
  * VoxForge: <session>/wav/*.wav + <session>/etc/PROMPTS lines
    ("<path> WORD WORD ...").
  * Sid: one dir per speaker containing the utterance WAVs plus a
    single ``prompts.txt`` whose line N transcribes the WAV whose
    trailing number is N.
  * CSLU Spoltech: paired wav/txt tree, but transcripts are Latin-1
    encoded (not UTF-8), extensions appear in upper/lower case, and
    some transcript files are empty/missing -> those utterances are
    skipped.

Usage:
  python -m tpuasr_torch.data.corpus lapsbm --source <dir|archive|url> \
      --out-dir <out> --manifest <m.csv> [--min-duration 1 --max-duration 15]
"""

from __future__ import annotations

import os
import re
import unicodedata
from pathlib import Path

from tpuasr_torch.audio.io import load_audio, save_audio
from tpuasr_torch.data.manifest import (
    ManifestEntry,
    order_and_prune,
    with_durations,
    write_manifest,
)

TARGET_SR = 16000


def fetch_corpus(source: str, cache_dir: str) -> str:
    """Acquire a corpus source: URL download + archive extraction.

    The reference's prep scripts downloaded and unpacked each corpus
    before parsing (ref:data/ per SURVEY.md §3.1); this is that layer.
    Accepts, and returns a local DIRECTORY for:
      * a directory path — returned as-is (no copy);
      * a local ``.tar[.gz|.bz2]``/``.tgz``/``.zip`` archive — extracted
        under ``cache_dir`` (idempotent: a ``.extracted`` marker skips
        re-extraction);
      * an ``http(s)://`` or ``file://`` URL to such an archive —
        downloaded to ``cache_dir`` first (atomic ``.part`` rename;
        an existing complete download is reused).
    Extraction refuses path-traversal members (``..`` / absolute).

    No corpus URLs are baked in: the reference's mirrors move and this
    build environment has no network to validate them — pass the URL
    of your mirror (or a pre-downloaded archive) explicitly."""
    import shutil
    import tarfile
    import urllib.parse
    import urllib.request
    import zipfile

    cache = Path(cache_dir)
    parsed = urllib.parse.urlparse(source)
    if parsed.scheme in ("http", "https", "file"):
        cache.mkdir(parents=True, exist_ok=True)
        name = os.path.basename(parsed.path) or "corpus.archive"
        archive = cache / name
        if not archive.exists():
            part = archive.with_suffix(archive.suffix + ".part")
            with urllib.request.urlopen(source) as r, open(part, "wb") as f:
                shutil.copyfileobj(r, f)
            os.replace(part, archive)
        source = str(archive)

    src = Path(source)
    if src.is_dir():
        return str(src)
    if not src.exists():
        raise FileNotFoundError(f"corpus source {source} does not exist")

    cache.mkdir(parents=True, exist_ok=True)
    stem = src.name
    for suf in (".tar.gz", ".tar.bz2", ".tgz", ".tar", ".zip"):
        if stem.endswith(suf):
            stem = stem[: -len(suf)]
            break
    dest = cache / stem
    marker = dest / ".extracted"
    if marker.exists():
        return str(dest)
    dest.mkdir(parents=True, exist_ok=True)

    def _safe(names):
        for n in names:
            p = Path(n)
            if p.is_absolute() or ".." in p.parts:
                raise ValueError(f"archive member escapes target: {n!r}")

    if zipfile.is_zipfile(src):
        with zipfile.ZipFile(src) as z:
            _safe(z.namelist())
            z.extractall(dest)
    elif tarfile.is_tarfile(src):
        with tarfile.open(src) as t:
            _safe(t.getnames())
            # filter="data" is Python 3.12's sanitizer (strips suid,
            # device nodes, absolute paths) — defense in depth on top
            # of the explicit traversal check above
            t.extractall(dest, filter="data")
    else:
        raise ValueError(
            f"{source} is neither a directory nor a recognized archive "
            "(.tar/.tar.gz/.tgz/.tar.bz2/.zip)")
    marker.touch()
    return str(dest)


def normalize_transcript(text: str, keep_accents: bool = True) -> str:
    """Uppercase, strip punctuation/digit-free normalization used by the
    reference family for PT-BR transcripts."""
    text = text.strip().upper()
    if not keep_accents:
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    text = re.sub(r"[!?.,;:\"()\[\]{}«»…—–]", " ", text)
    text = text.replace("-", " ")
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def _convert_pair(wav_src: Path, text: str, out_dir: Path, stem: str,
                  sample_rate: int = TARGET_SR) -> ManifestEntry:
    out_dir.mkdir(parents=True, exist_ok=True)
    wav_out = out_dir / f"{stem}.wav"
    txt_out = out_dir / f"{stem}.txt"
    audio = load_audio(str(wav_src), expected_sample_rate=sample_rate)
    save_audio(str(wav_out), audio, sample_rate)
    txt_out.write_text(normalize_transcript(text) + "\n", encoding="utf-8")
    return ManifestEntry(str(wav_out), str(txt_out))


def _finish(entries: list[ManifestEntry],
            manifest_path: str) -> list[ManifestEntry]:
    entries = sorted(with_durations(entries), key=lambda e: e.duration)
    write_manifest(manifest_path, entries)
    return entries


def _read_text_any(path: Path) -> str:
    """Transcript read tolerant of the corpora's mixed encodings: UTF-8
    first, then Latin-1 (CSLU Spoltech ships ISO-8859-1 transcripts)."""
    raw = path.read_bytes()
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError:
        return raw.decode("latin-1")


def _scan_pairs(src: Path, wav_suffix: str = ".wav",
                txt_suffix: str = ".txt") -> list[tuple[Path, str]]:
    """(wav, transcript text) pairs from a matching-stem tree.
    Extensions match case-insensitively; empty transcripts are skipped
    (both occur in the CSLU Spoltech distribution)."""
    pairs = []
    for wav in sorted(src.rglob("*")):
        if wav.suffix.lower() != wav_suffix.lower() or not wav.is_file():
            continue
        txt = None
        for cand in (wav.with_suffix(txt_suffix),
                     wav.with_suffix(txt_suffix.upper())):
            if cand.exists():
                txt = cand
                break
        if txt is None:
            continue
        text = _read_text_any(txt).strip()
        if not text:
            continue
        pairs.append((wav, text))
    return pairs


def prepare_pairs(
    source: str, out_dir: str, manifest_path: str,
    wav_suffix: str = ".wav", txt_suffix: str = ".txt",
    sample_rate: int = TARGET_SR,
) -> list[ManifestEntry]:
    """Generic paired wav/txt tree (also the fallback for the named
    corpus layouts when their specific markers are absent)."""
    src = Path(source)
    entries = []
    for wav, text in _scan_pairs(src, wav_suffix, txt_suffix):
        rel = wav.relative_to(src)
        stem = "_".join(rel.with_suffix("").parts)
        entries.append(_convert_pair(wav, text, Path(out_dir), stem,
                                     sample_rate))
    return _finish(entries, manifest_path)


def prepare_lapsbm(
    source: str, out_dir: str, manifest_path: str,
    sample_rate: int = TARGET_SR,
) -> list[ManifestEntry]:
    """LapsBM1.4 (the reference family's standard PT-BR *test* set):
    speaker dirs ``LapsBM-F###``/``LapsBM-M###`` (F/M = speaker sex),
    each holding paired ``LapsBM_####-NN.wav`` + ``.txt`` utterances
    [M confidence — SURVEY.md §0]. Output stems are
    ``<speaker>_<utterance>`` so downstream splits can group by the
    leading speaker component. Falls back to the generic pair scan when
    no ``LapsBM*`` speaker dirs exist."""
    src = Path(source)
    # require the sex marker + digits: a container dir named plain
    # "LapsBM" holding the speaker dirs must NOT itself match, or its
    # rglob'd wavs would be ingested twice (once via the container,
    # once via each speaker dir)
    speaker_dirs = sorted(
        d for d in src.rglob("LapsBM*") if d.is_dir()
        and re.match(r"LapsBM-?[FM]\d+$", d.name)
    )
    if not speaker_dirs:
        return prepare_pairs(source, out_dir, manifest_path,
                             sample_rate=sample_rate)
    entries = []
    for spk in speaker_dirs:
        for wav, text in _scan_pairs(spk):
            stem = f"{spk.name}_{wav.stem}"
            entries.append(_convert_pair(wav, text, Path(out_dir), stem,
                                         sample_rate))
    return _finish(entries, manifest_path)


def prepare_cetuc(
    source: str, out_dir: str, manifest_path: str,
    sample_rate: int = TARGET_SR,
) -> list[ManifestEntry]:
    """CETUC ("alcaim": ~100 speakers x ~1000 read sentences, paired
    wav/txt inside one directory per speaker [M]). Identical file
    mechanics to the pair scan but stems are ``<speaker>_<sentence>``
    taken from the immediate speaker dir, and nested non-speaker levels
    (e.g. an extra ``alcaim/`` root inside the archive) are skipped."""
    src = Path(source)
    entries = []
    for wav, text in _scan_pairs(src):
        spk = wav.parent.name if wav.parent != src else "root"
        stem = f"{spk}_{wav.stem}"
        entries.append(_convert_pair(wav, text, Path(out_dir), stem,
                                     sample_rate))
    return _finish(entries, manifest_path)


_TRAILING_NUM = re.compile(r"(\d+)$")


def prepare_sid(
    source: str, out_dir: str, manifest_path: str,
    sample_rate: int = TARGET_SR,
) -> list[ManifestEntry]:
    """Sid corpus: one dir per speaker holding the utterance WAVs plus a
    single ``prompts.txt`` where line N (1-based; lines may carry a
    leading "N=" or "N." index) transcribes the WAV whose filename ends
    in number N [M confidence — SURVEY.md §0]. Speaker dirs without a
    prompts file fall back to paired wav/txt."""
    src = Path(source)
    entries = []
    leaf_dirs = sorted({w.parent for w in src.rglob("*")
                        if w.suffix.lower() == ".wav"})
    for spk in leaf_dirs:
        prompts = None
        for cand in ("prompts.txt", "PROMPTS.txt", "text.txt"):
            if (spk / cand).exists():
                prompts = spk / cand
                break
        wavs = sorted(p for p in spk.iterdir()
                      if p.suffix.lower() == ".wav")
        if prompts is None:
            for wav, text in _scan_pairs(spk):
                stem = f"{spk.name}_{wav.stem}"
                entries.append(_convert_pair(wav, text, Path(out_dir),
                                             stem, sample_rate))
            continue
        lines = [ln.strip() for ln in
                 _read_text_any(prompts).splitlines() if ln.strip()]
        by_index: dict[int, str] = {}
        for i, ln in enumerate(lines):
            m = re.match(r"^(\d+)\s*[=.:)\-]\s*(.+)$", ln)
            if m:
                by_index[int(m.group(1))] = m.group(2)
            else:
                by_index[i + 1] = ln
        for wav in wavs:
            m = _TRAILING_NUM.search(wav.stem)
            if not m:
                continue
            text = by_index.get(int(m.group(1)))
            if not text:
                continue
            stem = f"{spk.name}_{wav.stem}"
            entries.append(_convert_pair(wav, text, Path(out_dir), stem,
                                         sample_rate))
    return _finish(entries, manifest_path)


def prepare_spoltech(
    source: str, out_dir: str, manifest_path: str,
    sample_rate: int = TARGET_SR,
) -> list[ManifestEntry]:
    """CSLU Spoltech Port (LDC2006S16): paired wav/txt tree with
    Latin-1 transcripts, mixed-case extensions, and some empty/missing
    transcripts (skipped) [M]. The tolerant pair scan handles all of
    that; this wrapper exists so the CLI surface mirrors the
    reference's one-script-per-corpus layout."""
    return prepare_pairs(source, out_dir, manifest_path,
                         sample_rate=sample_rate)


def prepare_voxforge(
    source: str, out_dir: str, manifest_path: str,
    sample_rate: int = TARGET_SR,
) -> list[ManifestEntry]:
    """VoxForge session layout: <session>/etc/PROMPTS + <session>/wav/."""
    src = Path(source)
    entries = []
    for prompts in sorted(src.rglob("PROMPTS")):
        session = prompts.parent.parent
        for line in prompts.read_text(encoding="utf-8",
                                      errors="replace").splitlines():
            parts = line.strip().split(None, 1)
            if len(parts) != 2:
                continue
            path_key, text = parts
            utt = path_key.split("/")[-1]
            wav = session / "wav" / f"{utt}.wav"
            if not wav.exists():
                continue
            stem = f"{session.name}_{utt}"
            entries.append(
                _convert_pair(wav, text, Path(out_dir), stem, sample_rate)
            )
    entries = sorted(with_durations(entries), key=lambda e: e.duration)
    write_manifest(manifest_path, entries)
    return entries


CORPORA = {
    "lapsbm": prepare_lapsbm,
    "cetuc": prepare_cetuc,
    "voxforge": prepare_voxforge,
    "sid": prepare_sid,
    "spoltech": prepare_spoltech,
}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Prepare a PT-BR corpus: resample to 16 kHz mono, "
        "normalize transcripts, emit a duration-sorted manifest."
    )
    p.add_argument("corpus", choices=sorted(CORPORA))
    p.add_argument("--source", required=True,
                   help="corpus directory, archive (.tar[.gz]/.zip), or "
                   "http(s)/file URL of one (downloaded + extracted to "
                   "--cache-dir; the reference's download step)")
    p.add_argument("--cache-dir", default=None,
                   help="where URL downloads / archive extractions land "
                   "(default <out-dir>/_cache)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--manifest", required=True)
    p.add_argument("--sample-rate", type=int, default=TARGET_SR)
    p.add_argument("--min-duration", type=float, default=None,
                   help="prune utterances shorter than this (seconds)")
    p.add_argument("--max-duration", type=float, default=None,
                   help="prune utterances longer than this (seconds)")
    args = p.parse_args(argv)
    source = fetch_corpus(
        args.source, args.cache_dir or os.path.join(args.out_dir, "_cache")
    )
    entries = CORPORA[args.corpus](
        source, args.out_dir, args.manifest, sample_rate=args.sample_rate
    )
    if args.min_duration is not None or args.max_duration is not None:
        entries = order_and_prune(entries, args.min_duration,
                                  args.max_duration)
        write_manifest(args.manifest, entries)
    print(f"{args.corpus}: {len(entries)} utterances -> {args.manifest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
