"""HTTP batch-transcription server (port of ``tpuasr/cli/serve.py``).

Usage:
  python -m tpuasr_torch.cli.serve --model-path model.ckpt --port 8080 \
      [--max-batch 32 --batch-window-ms 10] [--device cuda|cpu] \
      [--decoder greedy|beam|beam-device --lm-path lm.arpa]

  curl -X POST --data-binary @utt.wav http://host:8080/transcribe
  -> {"text": "...", "offsets": [...]}

With ``--streaming`` (a unidirectional checkpoint) it also hosts live
streams: POST /stream/open -> {"id": N}; /stream/<id>/feed with raw
int16 LE PCM (or f32 with ``X-Audio-Format: f32``) -> {"text": ...};
/stream/<id>/close -> {"text": ..., "offsets": [...]}. Up to
``--max-streams`` sessions share one batched step a tick.
"""

from __future__ import annotations

import argparse

from tpuasr_torch.audio.frontend import corpus_feature_stats
from tpuasr_torch.cli.opts import add_decoder_args, add_runtime_args, build_decoder
from tpuasr_torch.serve import (
    ServeConfig,
    StreamServeConfig,
    StreamSessionService,
    TranscriptionService,
    make_http_server,
)
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
                   help="enable live-stream sessions (POST /stream/*; needs a "
                   "unidirectional checkpoint): concurrent streams share one "
                   "batched device step")
    p.add_argument("--max-streams", type=int, default=8,
                   help="concurrent live-stream sessions (batch rows)")
    p.add_argument("--stream-chunk-frames", type=int, default=32,
                   help="feature frames per streaming step")
    p.add_argument("--session-timeout", type=float, default=300.0,
                   help="seconds of silence before a live-stream session is "
                   "reaped")
    p.add_argument("--stream-norm-stats", default=None, metavar="MANIFEST",
                   help="prime the streaming causal normalization with corpus "
                   "statistics of this manifest")
    p.add_argument("--stream-norm-weight", type=float, default=500.0,
                   help="prior weight of --stream-norm-stats in frames")
    p.add_argument("--stream-beam-impl", default="auto",
                   choices=["auto", "host", "native", "device"],
                   help="live-stream beam engine: device = K3 carrying each "
                   "session's beam state across ticks on the GPU; host = the "
                   "host beam; auto = device on a GPU, host on the CPU; "
                   "native is not ported")
    add_decoder_args(p)
    add_runtime_args(p)
    args = p.parse_args(argv)

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
    stream_service = None
    if args.streaming:
        prime = None
        if args.stream_norm_stats:
            mean, var = corpus_feature_stats(args.stream_norm_stats, pkg.frontend_config)
            prime = (mean, var, args.stream_norm_weight)
        stream_service = StreamSessionService(
            args.model_path,
            StreamServeConfig(
                max_streams=args.max_streams, chunk_frames=args.stream_chunk_frames,
                session_timeout_s=args.session_timeout, prime_stats=prime,
                # sessions decode greedy unless the host beam decoder was
                # chosen; beam fuses --lm-path per session
                decoder="beam" if args.decoder == "beam" else "greedy",
                beam_impl=args.stream_beam_impl, lm_path=args.lm_path,
                alpha=args.alpha, beta=args.beta, beam_width=args.beam_width,
                cutoff_top_n=args.cutoff_top_n, cutoff_prob=args.cutoff_prob),
            package=pkg, variables=service.model, device=args.device)
    server = make_http_server(service, args.host, args.port,
                              stream_service=stream_service)
    print(f"tpuasr_torch serving on {args.host}:{args.port} "
          f"(max_batch={args.max_batch}, decoder={args.decoder}, "
          f"device={service.device}{', streaming' if stream_service else ''})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
        if stream_service is not None:
            stream_service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
