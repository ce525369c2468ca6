"""The port's data tools vs tpuasr's, on the CPU and on synthetic inputs
(nothing is downloaded): corpus preparation (``tpuasr_torch/data/
corpus.py``) on every layout, ``fetch_corpus`` from a directory, local
archives and a ``file://`` URL, the manifest CLI (``data/manifest.py``)
and ``cli/plot_metrics.py`` on a log the port's ``MetricsLogger`` wrote.
"""

import io
import math
import tarfile
import zipfile
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from torch_helpers import one_intra_op_thread  # noqa: F401 (autouse fixture)
from tpuasr.cli import plot_metrics as jax_plot
from tpuasr.data import corpus as jax_corpus
from tpuasr.data import manifest as jax_manifest
from tpuasr_torch.audio.io import load_audio, save_audio
from tpuasr_torch.cli import plot_metrics
from tpuasr_torch.data import corpus, manifest
from tpuasr_torch.train.logging import MetricsLogger


def _wav(path, n=4000, sr=16000, seed=0):
    save_audio(str(path), np.random.RandomState(seed).randn(n) * 0.1, sr)


def _pairs(root):
    src = root / "spk1"
    src.mkdir(parents=True)
    _wav(src / "a.wav", 8000, 8000, seed=1)  # 8 kHz: resampled to 16 kHz
    (src / "a.txt").write_text("Olá, mundo!")
    _wav(src / "b.wav", 16000, 8000, seed=2)
    (src / "b.txt").write_text("bom-dia;  tudo")


def _lapsbm(root):
    for spk, utt, text, n in [("LapsBM-F004", "LapsBM_0004-01", "uma frase", 4000),
                              ("LapsBM-M001", "LapsBM_0001-01", "outra frase", 5000)]:
        d = root / spk
        d.mkdir(parents=True, exist_ok=True)
        _wav(d / f"{utt}.wav", n)
        (d / f"{utt}.txt").write_text(text)
    _wav(root / "LapsBM-F004" / "orphan.wav")  # unpaired: ignored


def _flat(root):
    root.mkdir()
    _wav(root / "x.wav")
    (root / "x.txt").write_text("fala")


def _cetuc(root):
    for i, spk in enumerate(("Adriano", "Beatriz")):
        d = root / spk
        d.mkdir(parents=True)
        _wav(d / "sent001.wav", 4000 + 900 * i, seed=i)
        (d / "sent001.txt").write_text("frase um")


def _sid(root):
    d = root / "M001"
    d.mkdir(parents=True)
    for k, name in enumerate(("M001N0001", "M001N0002", "M001N0007")):  # no line 7
        _wav(d / f"{name}.wav", 3000 + 500 * k, seed=k)
    (d / "prompts.txt").write_text("1=primeira frase\n2= segunda frase\n", encoding="utf-8")
    d = root / "F002"
    d.mkdir()
    _wav(d / "F002N0001.wav", 4100)
    _wav(d / "F002N0002.wav", 4200)
    (d / "prompts.txt").write_text("frase a\nfrase b\n")  # line order is the index
    d = root / "M003"
    d.mkdir()
    _wav(d / "solo1.wav", 4300)
    (d / "solo1.txt").write_text("frase c")  # no prompts: paired files


def _spoltech(root):
    root.mkdir()
    _wav(root / "u1.wav")
    (root / "u1.txt").write_bytes("não é você".encode("latin-1"))
    _wav(root / "U3.WAV", 5000)
    (root / "U3.TXT").write_text("maiúsculas")
    _wav(root / "u2.wav")
    (root / "u2.txt").write_text("")  # empty: skipped


def _voxforge(root):
    sess = root / "spk-20100101-abc"
    (sess / "wav").mkdir(parents=True)
    (sess / "etc").mkdir()
    _wav(sess / "wav" / "pt-01.wav", 16000, seed=1)
    _wav(sess / "wav" / "pt-02.wav", 8000, seed=2)
    (sess / "etc" / "PROMPTS").write_text(
        "spk-20100101-abc/mfc/pt-01 ola mundo\n"
        "spk-20100101-abc/mfc/pt-02 tudo bem\n"
        "spk-20100101-abc/mfc/pt-99 missing file\n")


# name -> (layout builder, prepare_* function name, utterances kept)
LAYOUTS = {
    "pairs": (_pairs, "prepare_pairs", 2),
    "lapsbm": (_lapsbm, "prepare_lapsbm", 2),
    "lapsbm-fallback": (_flat, "prepare_lapsbm", 1),
    "cetuc": (_cetuc, "prepare_cetuc", 2),
    "sid": (_sid, "prepare_sid", 5),
    "spoltech": (_spoltech, "prepare_spoltech", 2),
    "voxforge": (_voxforge, "prepare_voxforge", 2),
}


def _summary(entries, out_dir):
    """Manifest entries with their paths made relative to ``out_dir``,
    transcripts and samples."""
    rows = []
    for e in entries:
        rows.append((str(Path(e.wav_path).relative_to(out_dir)),
                     str(Path(e.transcript_path).relative_to(out_dir)),
                     e.duration, e.read_transcript(), load_audio(e.wav_path).tobytes()))
    return rows


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prepare_matches_tpuasr(tmp_path, layout):
    """Each corpus layout: the same utterances, stems, normalised
    transcripts, durations, resampled samples and manifest lines."""
    build, fn, n = LAYOUTS[layout]
    src = tmp_path / "src"
    build(src)
    got = getattr(corpus, fn)(str(src), str(tmp_path / "o1"), str(tmp_path / "m1.csv"))
    want = getattr(jax_corpus, fn)(str(src), str(tmp_path / "o2"), str(tmp_path / "m2.csv"))
    assert len(got) == n
    assert _summary(got, tmp_path / "o1") == _summary(want, tmp_path / "o2")
    assert (tmp_path / "m1.csv").read_text().replace("/o1/", "/o2/") == \
        (tmp_path / "m2.csv").read_text()


def test_normalize_transcript_matches_tpuasr():
    for text in ("Olá, mundo!", "bom-dia;  tudo", "«Ação» — (teste)…", "  é  "):
        for keep in (True, False):
            assert corpus.normalize_transcript(text, keep) == \
                jax_corpus.normalize_transcript(text, keep)


def test_fetch_corpus_tar_zip_and_file_url(tmp_path):
    """A directory passes through; a .tar.gz extracts (once: the marker
    makes a second fetch a no-op); a .zip arrives through a file:// URL
    (downloaded first). Each gives tpuasr's directory and prepares."""
    root = tmp_path / "LapsBM1.4"
    _lapsbm(root)
    assert corpus.fetch_corpus(str(root), str(tmp_path / "c0")) == str(root)

    tgz = tmp_path / "laps.tar.gz"
    with tarfile.open(tgz, "w:gz") as t:
        t.add(root, arcname="LapsBM1.4")
    zp = tmp_path / "laps.zip"
    with zipfile.ZipFile(zp, "w") as z:
        for f in sorted(root.rglob("*")):
            if f.is_file():
                z.write(f, f"LapsBM1.4/{f.relative_to(root)}")
    for k, source in enumerate((str(tgz), f"file://{zp}")):
        got = corpus.fetch_corpus(source, str(tmp_path / f"c{k}a"))
        want = jax_corpus.fetch_corpus(source, str(tmp_path / f"c{k}b"))
        assert Path(got).relative_to(tmp_path / f"c{k}a") == \
            Path(want).relative_to(tmp_path / f"c{k}b")
        assert sorted(p.relative_to(got) for p in Path(got).rglob("*")) == \
            sorted(p.relative_to(want) for p in Path(want).rglob("*"))
        marker = Path(got) / ".extracted"
        before = marker.stat().st_mtime_ns
        assert corpus.fetch_corpus(source, str(tmp_path / f"c{k}a")) == got
        assert marker.stat().st_mtime_ns == before
        assert len(corpus.prepare_lapsbm(got, str(tmp_path / f"o{k}"),
                                         str(tmp_path / f"m{k}.csv"))) == 2
    assert (tmp_path / "c1a" / "laps.zip").exists()  # the downloaded copy


@pytest.mark.parametrize("kind", ["tar", "zip"])
def test_fetch_corpus_rejects_traversal(tmp_path, kind):
    payload = tmp_path / "x.txt"
    payload.write_text("boom")
    evil = tmp_path / f"evil.{kind}"
    if kind == "tar":
        with tarfile.open(evil, "w") as t:
            t.add(payload, arcname="../../escape.txt")
    else:
        with zipfile.ZipFile(evil, "w") as z:
            z.write(payload, "../../escape.txt")
    for fetch in (corpus.fetch_corpus, jax_corpus.fetch_corpus):
        with pytest.raises(ValueError, match="escapes"):
            fetch(str(evil), str(tmp_path / "c"))
    assert not (tmp_path / "escape.txt").exists()
    with pytest.raises(FileNotFoundError):
        corpus.fetch_corpus(str(tmp_path / "missing.tar"), str(tmp_path / "c"))


def _run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_corpus_cli_matches_tpuasr(tmp_path):
    """``python -m tpuasr_torch.data.corpus`` from an archive, pruned by
    duration: the same printed line and manifest as tpuasr's CLI."""
    root = tmp_path / "LapsBM1.4"
    _lapsbm(root)
    tgz = tmp_path / "laps.tgz"
    with tarfile.open(tgz, "w:gz") as t:
        t.add(root, arcname="LapsBM1.4")
    outs = []
    for main, tag in ((corpus.main, "a"), (jax_corpus.main, "b")):
        man = tmp_path / tag / "man.csv"
        rc, line = _run(main, ["lapsbm", "--source", str(tgz), "--out-dir",
                               str(tmp_path / tag / "out"), "--manifest", str(man),
                               "--max-duration", "0.3"])
        assert rc == 0
        outs.append((line.replace(f"/{tag}/", "/"),
                     man.read_text().replace(f"/{tag}/", "/")))
    assert outs[0] == outs[1]
    assert outs[0][0].startswith("lapsbm: 1 utterances -> ")


def test_manifest_cli_matches_tpuasr(tmp_path):
    """create | merge | prune: the same printed lines and manifests."""
    src = tmp_path / "src"
    _cetuc(src)
    _flat(tmp_path / "more")
    steps = [["create", str(src), "{out}/a.csv"],
             ["create", str(tmp_path / "more"), "{out}/b.csv", "--wav-suffix", ".wav"],
             ["merge", "{out}/a.csv", "{out}/b.csv", "--out", "{out}/all.csv"],
             ["prune", "{out}/all.csv", "--out", "{out}/p.csv", "--min-duration", "0.26",
              "--max-duration", "0.4"]]
    got = {}
    for main, tag in ((manifest.main, "port"), (jax_manifest.main, "jax")):
        out = tmp_path / tag
        out.mkdir()
        for argv in steps:
            rc, line = _run(main, [a.format(out=out) for a in argv])
            assert rc == 0
            got.setdefault(tag, []).append(line.replace(str(out), "OUT"))
        for name in ("a", "b", "all", "p"):
            got[tag].append((out / f"{name}.csv").read_text())
    assert got["port"] == got["jax"]
    assert got["port"][:4] == ["2 entries -> OUT/a.csv\n", "1 entries -> OUT/b.csv\n",
                               "3 entries -> OUT/all.csv\n", "1 entries -> OUT/p.csv\n"]


def test_plot_metrics_matches_tpuasr(tmp_path):
    """On a log the port's MetricsLogger wrote (and a torn tail line from
    a live writer): the same records, series, ``--list`` lines and
    printed line as tpuasr's, and a PNG where matplotlib is present."""
    logger = MetricsLogger(str(tmp_path))
    for i in range(20):
        logger.log(i, {"loss": 30 * math.exp(-i / 5)}, prefix="train/")
    for e in range(3):
        logger.log(e, {"wer": 100 - 20 * e, "cer": float("nan"), "lr": 3e-4}, prefix="epoch/")
    logger.close()
    with open(tmp_path / "metrics.jsonl", "a") as f:
        f.write('{"step": 99, "train/l')
    records = plot_metrics.load_records(str(tmp_path))
    assert records == jax_plot.load_records(str(tmp_path / "metrics.jsonl"))
    assert len(records) == 23
    for key in ("train/loss", "epoch/wer", "epoch/cer", "epoch/lr", "missing"):
        assert plot_metrics.series_of(records, key) == jax_plot.series_of(records, key)
    assert plot_metrics.available_keys(records) == jax_plot.available_keys(records) == \
        ["epoch/cer", "epoch/lr", "epoch/wer", "train/loss"]
    assert _run(plot_metrics.main, [str(tmp_path), "--list"]) == \
        _run(jax_plot.main, [str(tmp_path), "--list"])
    out = tmp_path / "curves.png"
    try:
        import matplotlib  # noqa: F401
    except ImportError:  # drawing needs it; --list above did not
        with pytest.raises(ImportError):
            plot_metrics.main([str(tmp_path)])
        return
    lines = []
    for main in (jax_plot.main, plot_metrics.main):
        out.unlink(missing_ok=True)
        lines.append(_run(main, [str(tmp_path)]))
        assert out.stat().st_size > 1000
    assert lines[0] == lines[1] == (0, f"wrote {out} (23 records, keys: train/loss, "
                                       "epoch/wer, epoch/cer, epoch/lr)\n")
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert plot_metrics.main([str(empty)]) == 1
