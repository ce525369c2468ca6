"""Train an n-gram LM from transcripts and write ARPA (port of
``tpuasr/cli/train_lm.py``).

Replaces the external KenLM ``lmplz`` step in the reference workflow
(the reference consumed a KenLM-built ARPA/binary LM; SURVEY.md §3.2).
Reads either a manifest (uses its transcript files) or a plain text
corpus, trains a backoff n-gram (tpuasr_torch.decode.lm.train_ngram), and
writes ARPA usable by --decoder beam --lm-path.

Usage:
  python -m tpuasr_torch.cli.train_lm --manifest train.csv --order 3 --out lm.arpa
  python -m tpuasr_torch.cli.train_lm --text corpus.txt --order 3 --out lm.arpa \
      [--char-level]
"""

from __future__ import annotations

import argparse
import sys

from tpuasr_torch.data.manifest import read_manifest
from tpuasr_torch.decode.lm import train_ngram


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="tpuasr_torch n-gram LM trainer")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--manifest", help="manifest CSV; transcripts are read")
    src.add_argument("--text", help="plain text corpus, one sentence/line")
    p.add_argument("--out", required=True, help="output ARPA path")
    p.add_argument("--order", type=int, default=3)
    p.add_argument("--add-k", type=float, default=0.01)
    p.add_argument("--min-count", type=int, default=1)
    p.add_argument("--char-level", action="store_true",
                   help="character tokens (for on-device beam fusion)")
    args = p.parse_args(argv)

    if args.manifest:
        lines = [e.read_transcript() for e in read_manifest(args.manifest)]
    else:
        with open(args.text, "r", encoding="utf-8") as f:
            lines = [ln.strip() for ln in f if ln.strip()]
    lines = [ln.upper() for ln in lines]
    if args.char_level:
        # one token per character; word boundary becomes the <sp> token
        # (pack_lm_tables maps it back to the space class id)
        lines = [
            " ".join("<sp>" if ch == " " else ch for ch in ln)
            for ln in lines
        ]

    lm = train_ngram(lines, order=args.order, add_k=args.add_k,
                     min_count=args.min_count)
    lm.save(args.out)
    n_grams = [len(t) for t in lm.ngrams]
    print(f"order={lm.order} ngrams={n_grams} vocab={len(lm.vocab)} "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
