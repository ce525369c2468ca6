"""HTTP batch-transcription server (port of ``tpuasr/cli/serve.py``).

Usage:
  python -m tpuasr_torch.cli.serve --model-path model.ckpt --port 8080 \
      [--max-batch 32 --batch-window-ms 10] [--device cuda|cpu] \
      [--decoder greedy|beam|beam-device --lm-path lm.arpa]

  curl -X POST --data-binary @utt.wav http://host:8080/transcribe
  -> {"text": "...", "offsets": [...]}
"""

from __future__ import annotations

import argparse

from tpuasr_torch.cli.opts import add_decoder_args, add_runtime_args, build_decoder
from tpuasr_torch.serve import ServeConfig, TranscriptionService, make_http_server
from tpuasr_torch.train.checkpoint import load_checkpoint


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="tpuasr_torch transcription server")
    p.add_argument("--model-path", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--batch-window-ms", type=float, default=10.0)
    p.add_argument("--warmup-seconds", type=float, nargs="*", default=[],
                   help="run these request-duration buckets once before "
                   "listening")
    p.add_argument("--long-audio", default="chunk",
                   choices=["chunk", "reject", "truncate"],
                   help="requests beyond the bucket ladder: chunked "
                   "long-form decode (full transcript), reject, or "
                   "explicit truncation")
    p.add_argument("--chunk-overlap", type=float, default=2.0,
                   help="chunk overlap (s) for long-form decode")
    p.add_argument("--streaming", action="store_true",
                   help="live-stream sessions (not ported yet)")
    p.add_argument("--max-streams", type=int, default=8)
    p.add_argument("--stream-chunk-frames", type=int, default=32)
    p.add_argument("--session-timeout", type=float, default=300.0)
    p.add_argument("--stream-norm-stats", default=None, metavar="MANIFEST")
    p.add_argument("--stream-norm-weight", type=float, default=500.0)
    p.add_argument("--stream-beam-impl", default="auto",
                   choices=["auto", "host", "native", "device"])
    add_decoder_args(p)
    add_runtime_args(p)
    args = p.parse_args(argv)

    if args.streaming:
        raise NotImplementedError(
            "--streaming is not yet ported (ROADMAP.md: unidirectional, "
            "Lookahead and streaming)")
    pkg = load_checkpoint(args.model_path)
    decoder = build_decoder(args, pkg.alphabet)
    service = TranscriptionService(
        args.model_path,
        ServeConfig(max_batch=args.max_batch,
                    batch_window_ms=args.batch_window_ms,
                    warmup_seconds=tuple(args.warmup_seconds),
                    long_audio=args.long_audio,
                    chunk_overlap=args.chunk_overlap),
        decoder=decoder, package=pkg, device=args.device, rnn_impl=args.rnn_impl,
    )
    server = make_http_server(service, args.host, args.port)
    print(f"tpuasr_torch serving on {args.host}:{args.port} "
          f"(max_batch={args.max_batch}, decoder={args.decoder}, "
          f"device={service.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
