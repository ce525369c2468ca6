"""The port's streaming transcription (tpuasr_torch.stream) against
tpuasr.stream on the same weights and ragged feeds, and against the
port's own offline model; the beam engines, the multi-stream
transcriber, the HTTP sessions and ``cli.transcribe --streaming``.

The JAX streaming step is slow to compile on the CPU, so two JAX
transcribers (normalize off; normalize on with primed statistics) and
one JAX CLI run are shared through module fixtures; every other check
holds the port to itself (streamed vs offline, multi-stream vs single,
device beam vs host beam).

Tolerances: streamed logits within 2e-4 of the offline model's and of
tpuasr's in f32 (tests/test_stream.py's); texts and offsets equal.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tpuasr_torch.audio.frontend import FrontendConfig, corpus_feature_stats, log_spectrogram
from tpuasr_torch.compat.weights import init_variables, model_from_variables
from tpuasr_torch.decode.beam_host import prefix_beam_search
from tpuasr_torch.decode.greedy import GreedyDecoder
from tpuasr_torch.decode.lm import train_ngram
from tpuasr_torch.labels import Alphabet
from tpuasr_torch.model.ds2 import ModelConfig
from tpuasr_torch.serve import StreamServeConfig, StreamSessionService, make_http_server
from tpuasr_torch.stream import MultiStreamTranscriber, StreamingTranscriber
from tpuasr_torch.train import checkpoint as ckpt

CPU = torch.device("cpu")
ABC = Alphabet(labels="_ AB")
# seeds whose random weights emit several characters on _wave's tones
SEEDS = {"gru": 1, "lstm": 0, "rnn": 5}
LM_LINES = ["AB A B", "B AB", "A AB B", "BA BA AB"]


def _setup(rnn_type="gru", lookahead=4, seed=None):
    cfg = ModelConfig(n_classes=ABC.size, hidden_size=32, hidden_layers=2,
                      rnn_type=rnn_type, bidirectional=False,
                      lookahead_context=lookahead, compute_dtype="float32")
    variables = init_variables(cfg, seed=SEEDS[rnn_type] if seed is None else seed)
    # a sharper head, so that the argmax follows the input
    variables["params"]["head_bn"]["bias"][:] = 0.0
    variables["batch_stats"]["head_bn"]["var"][:] = 0.01
    return cfg, variables


def _wave(seed, n):
    """Tones of random pitch and loudness, a quarter second each."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    seg = (t * 4).astype(int)
    f = 200 + 300 * rng.rand(seg.max() + 1)
    amp = rng.rand(seg.max() + 1) ** 2
    return (amp[seg] * np.sin(2 * np.pi * f[seg] * t)
            + 0.02 * rng.randn(n)).astype(np.float32)


def _offline(cfg, variables, fe, wave):
    model = model_from_variables(variables, cfg, CPU)
    with torch.inference_mode():
        feats, flen = log_spectrogram(torch.from_numpy(wave[None]),
                                      torch.tensor([len(wave)]), fe)
        logits, out_len = model(feats, flen)
    return logits[0].numpy(), int(out_len[0])


def _stream(st, wave, step):
    frags = [st.feed(wave[i:i + step]) for i in range(0, len(wave), step)]
    frags.append(st.flush())
    assert "".join(frags) == st.text
    return st


def _prime(fe):
    return (0.9, 0.4, 50.0) if fe.normalize else None


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many small torch ops (the chunk loop, K3's plain
    version); with the suite's workers sharing the cores, one intra-op
    thread a worker runs them many times faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ vs tpuasr

@pytest.fixture(scope="module")
def jax_streams():
    """tpuasr.stream.StreamingTranscriber's text, offsets and logits
    for normalize off and for normalize on with primed statistics."""
    from tpuasr.audio.frontend import FrontendConfig as JaxFrontendConfig
    from tpuasr.labels import Alphabet as JaxAlphabet
    from tpuasr.model.ds2 import ModelConfig as JaxConfig
    from tpuasr.stream import StreamingTranscriber as JaxStreaming

    cfg, variables = _setup("gru")
    wave = _wave(7, 21000)
    out = {}
    for normalize in (False, True):
        fe = FrontendConfig(normalize=normalize)
        st = _stream(JaxStreaming(variables, JaxConfig.from_dict(cfg.to_dict()),
                                  JaxFrontendConfig(normalize=normalize),
                                  JaxAlphabet(labels=ABC.labels), chunk_frames=16,
                                  collect_logits=True, prime_stats=_prime(fe)), wave, 777)
        out[normalize] = (st.text, st.offsets, st.logits())
    return out


@pytest.mark.parametrize("normalize", [False, True], ids=["plain", "primed-normalize"])
def test_streaming_matches_jax(jax_streams, normalize):
    cfg, variables = _setup("gru")
    fe = FrontendConfig(normalize=normalize)
    st = _stream(StreamingTranscriber(variables, cfg, fe, ABC, chunk_frames=16,
                                      collect_logits=True, prime_stats=_prime(fe),
                                      device="cpu"), _wave(7, 21000), 777)
    text, offsets, logits = jax_streams[normalize]
    assert len(text) >= 4
    assert st.text == text
    np.testing.assert_array_equal(st.offsets, offsets)
    assert st.logits().shape == logits.shape
    np.testing.assert_allclose(st.logits(), logits, rtol=2e-4, atol=2e-4)


def test_corpus_feature_stats_matches_jax(tmp_path):
    from tpuasr.audio.frontend import FrontendConfig as JaxFrontendConfig
    from tpuasr.audio.frontend import corpus_feature_stats as jax_stats

    rows = []
    for i, n in enumerate((9000, 12345, 4000)):
        path = str(tmp_path / f"u{i}.wav")
        wavfile.write(path, 16000, (_wave(i, n) * 20000).astype(np.int16))
        rows.append(f"{path},{path}.txt\n")
    manifest = tmp_path / "m.csv"
    manifest.write_text("".join(rows))
    for max_utts in (256, 2):  # all rows, and the seeded sample
        got = corpus_feature_stats(str(manifest), FrontendConfig(), max_utts=max_utts)
        want = jax_stats(str(manifest), JaxFrontendConfig(), max_utts=max_utts)
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------- vs the offline model

@pytest.mark.parametrize("rnn_type", ["gru", "lstm", "rnn"])
@pytest.mark.parametrize("chunk_frames", [16, 32])
def test_stream_matches_offline(rnn_type, chunk_frames):
    cfg, variables = _setup(rnn_type)
    fe = FrontendConfig(normalize=False)
    wave = _wave(7, 21000)
    ref, t1 = _offline(cfg, variables, fe, wave)
    st = _stream(StreamingTranscriber(variables, cfg, fe, ABC, chunk_frames=chunk_frames,
                                      collect_logits=True, device="cpu"), wave, 777)
    assert st.logits().shape == (t1, ABC.size)
    np.testing.assert_allclose(st.logits(), ref[:t1], rtol=2e-4, atol=2e-4)
    texts, offsets = GreedyDecoder(ABC).decode(ref[None], np.array([t1]),
                                               return_offsets=True)
    assert st.text == texts[0] and len(st.text) >= 4
    np.testing.assert_array_equal(st.offsets, offsets[0])


def test_stream_without_lookahead_and_with_one_frame():
    """lookahead 0 (no layer) and 1 (no delay buffer) stream exactly."""
    for lookahead in (0, 1):
        cfg, variables = _setup("gru", lookahead=lookahead)
        fe = FrontendConfig(normalize=False)
        wave = _wave(3, 9000)
        ref, t1 = _offline(cfg, variables, fe, wave)
        st = _stream(StreamingTranscriber(variables, cfg, fe, ABC, chunk_frames=16,
                                          collect_logits=True, device="cpu"), wave, 500)
        np.testing.assert_allclose(st.logits(), ref[:t1], rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------- multi-stream

def _feed_all(mst, sids, waves, steps):
    pos = [0] * len(waves)
    while any(p < len(w) for p, w in zip(pos, waves)):
        for j, (sid, w) in enumerate(zip(sids, waves)):
            if pos[j] < len(w):
                mst.feed(sid, w[pos[j]:pos[j] + steps[j]])
                pos[j] += steps[j]
        mst.tick()


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_multistream_matches_single(rnn_type):
    cfg, variables = _setup(rnn_type)
    fe = FrontendConfig(normalize=True)
    prime = (0.9, 0.4, 50.0)
    waves = [_wave(s, n) for s, n in ((7, 21000), (8, 13000), (9, 6000))]
    singles = [_stream(StreamingTranscriber(variables, cfg, fe, ABC, chunk_frames=16,
                                            prime_stats=prime, device="cpu"), w, 4000)
               for w in waves]
    mst = MultiStreamTranscriber(variables, cfg, fe, ABC, max_streams=4, chunk_frames=16,
                                 prime_stats=prime, device="cpu")
    sids = [mst.open() for _ in waves]
    _feed_all(mst, sids, waves, (1234, 999, 777))
    for sid, single in zip(sids, singles):
        mst.flush(sid)
        assert mst.text(sid) == single.text
        np.testing.assert_array_equal(mst.offsets(sid), single.offsets)


def test_multistream_slot_reuse_unpolluted():
    """A slot reopened after close() starts from the initial carry (the
    primed template, not the last stream's state): its stream equals a
    fresh single stream while another stream keeps running."""
    cfg, variables = _setup("rnn")
    fe = FrontendConfig(normalize=True)
    prime = (0.9, 0.4, 500.0)
    mst = MultiStreamTranscriber(variables, cfg, fe, ABC, max_streams=2, chunk_frames=16,
                                 prime_stats=prime, device="cpu")
    a, b = mst.open(), mst.open()
    _feed_all(mst, [a, b], [_wave(1, 12000), _wave(2, 20000)], (800, 800))
    mst.flush(a)
    mst.close(a)
    c = mst.open()
    assert c == a
    fresh = _wave(4, 9000)
    _feed_all(mst, [c], [fresh], (700,))
    mst.flush(c)
    single = _stream(StreamingTranscriber(variables, cfg, fe, ABC, chunk_frames=16,
                                          prime_stats=prime, device="cpu"), fresh, 700)
    assert mst.text(c) == single.text and len(single.text) >= 2
    np.testing.assert_array_equal(mst.offsets(c), single.offsets)


def test_multistream_take_text_and_lifecycle():
    cfg, variables = _setup("gru")
    fe = FrontendConfig(normalize=False)
    mst = MultiStreamTranscriber(variables, cfg, fe, ABC, max_streams=1, chunk_frames=16,
                                 device="cpu")
    sid = mst.open()
    with pytest.raises(RuntimeError, match="slots in use"):
        mst.open()
    wave, taken = _wave(7, 21000), []
    for i in range(0, len(wave), 1500):
        mst.feed(sid, wave[i:i + 1500])
        while mst.tick():
            pass
        taken.append(mst.take_text(sid))
    mst.begin_flush(sid)
    while not mst.flush_done(sid):
        assert mst.tick()
    final = mst.finalize_flush(sid)
    taken.append(mst.take_text(sid))
    assert "".join(taken) == final == mst.text(sid) and len(final) >= 4
    with pytest.raises(RuntimeError, match="closed"):
        mst.feed(sid, wave[:100])
    mst.close(sid)
    with pytest.raises(KeyError):
        mst.text(sid)


# ---------------------------------------------------------------- beam

def _log_softmax(x):
    m = x.max(axis=-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


BEAM = dict(decoder="beam", alpha=0.5, beta=0.3, beam_width=6)


@pytest.mark.parametrize("with_lm", [False, True], ids=["no-lm", "word-lm"])
def test_stream_host_beam_matches_offline(with_lm):
    cfg, variables = _setup("gru")
    fe = FrontendConfig(normalize=False)
    wave = _wave(7, 16500)
    ref, t1 = _offline(cfg, variables, fe, wave)
    lm = train_ngram(LM_LINES, order=2) if with_lm else None
    offline = prefix_beam_search(_log_softmax(ref[:t1].astype(np.float64)), ABC,
                                 beam_width=6, lm=lm, alpha=0.5, beta=0.3)[0][0]
    st = _stream(StreamingTranscriber(variables, cfg, fe, ABC, chunk_frames=16, lm=lm,
                                      beam_impl="host", device="cpu", **BEAM), wave, 1234)
    assert st.text == offline and len(offline) >= 4


@pytest.mark.parametrize("with_lm", [False, True], ids=["no-lm", "word-lm"])
def test_device_beam_matches_host(with_lm):
    """The device engine (K3's stateful mode; its plain version on the
    CPU) gives the host engine's text and offsets, for one stream and
    for two streams sharing the ticks."""
    cfg, variables = _setup("gru")
    fe = FrontendConfig(normalize=False)
    lm = train_ngram(LM_LINES, order=2) if with_lm else None
    wave = _wave(7, 10000)

    def single(impl):
        st = StreamingTranscriber(variables, cfg, fe, ABC, chunk_frames=16, lm=lm,
                                  beam_impl=impl, device="cpu", **BEAM)
        assert (st._dev_engine is not None) == (impl == "device")
        st = _stream(st, wave, 901)
        return st.text, st.offsets

    dev_text, dev_offs = single("device")
    host_text, host_offs = single("host")
    assert dev_text == host_text and len(host_text) >= 4
    np.testing.assert_array_equal(dev_offs, host_offs)

    waves = [wave, _wave(8, 7000)]

    def multi(impl):
        mst = MultiStreamTranscriber(variables, cfg, fe, ABC, max_streams=2,
                                     chunk_frames=16, lm=lm, beam_impl=impl,
                                     device="cpu", **BEAM)
        sids = [mst.open() for _ in waves]
        _feed_all(mst, sids, waves, (1234, 999))
        for sid in sids:
            mst.flush(sid)
        return [(mst.text(s), mst.offsets(s)) for s in sids]

    dev_multi = multi("device")
    for (dt_, do), (ht, ho) in zip(dev_multi, multi("host")):
        assert dt_ == ht
        np.testing.assert_array_equal(do, ho)
    assert dev_multi[0][0] == dev_text


def test_native_beam_raises_naming_its_roadmap_item():
    cfg, variables = _setup("gru")
    for cls in (StreamingTranscriber, MultiStreamTranscriber):
        with pytest.raises(NotImplementedError, match="§1.5"):
            cls(variables, cfg, FrontendConfig(), ABC, beam_impl="native", device="cpu",
                **BEAM)


def test_streaming_refuses_a_bidirectional_model():
    cfg, _ = _setup("gru")
    bi = ModelConfig(**{**cfg.to_dict(), "bidirectional": True})
    with pytest.raises(ValueError, match="unidirectional"):
        StreamingTranscriber(init_variables(bi), bi, FrontendConfig(), ABC, device="cpu")


# ---------------------------------------------------------------- serving

def _post(url, body=b"", headers=None):
    req = urllib.request.Request(url, data=body, method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_stream_sessions_over_http(tmp_path):
    cfg, variables = _setup("gru")
    fe = FrontendConfig(normalize=False)
    path = str(tmp_path / "uni.ckpt")
    ckpt.save_checkpoint(path, ckpt.CheckpointPackage(
        model_config=cfg, frontend_config=fe, labels=ABC.labels, variables=variables))
    wave = _wave(7, 21000)
    pcm = (np.clip(wave, -1, 1) * 32767).astype(np.int16)
    want = _stream(StreamingTranscriber(variables, cfg, fe, ABC, chunk_frames=16,
                                        device="cpu"), pcm.astype(np.float32) / 32768.0, 4000)
    svc = StreamSessionService(path, StreamServeConfig(max_streams=2, chunk_frames=16),
                               device="cpu")
    server = make_http_server(None, "127.0.0.1", 0, stream_service=svc)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        sid = _post(f"{base}/stream/open")["id"]
        got = "".join(_post(f"{base}/stream/{sid}/feed", pcm[i:i + 3000].tobytes())["text"]
                      for i in range(0, len(pcm), 3000))
        out = _post(f"{base}/stream/{sid}/close")
        assert out["text"] == want.text and got == want.text[:len(got)]
        assert out["offsets"] == want.offsets.tolist()
        sid2 = _post(f"{base}/stream/open")["id"]
        assert sid2 != sid  # generation-stamped, though the slot is reused
        f32 = _post(f"{base}/stream/{sid2}/feed", wave[:2000].tobytes(),
                    {"X-Audio-Format": "f32"})
        assert f32 == {"text": ""}
        for stale in (f"{base}/stream/{sid}/feed", f"{base}/stream/{sid}/close"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(stale, pcm[:100].tobytes())
            assert err.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{base}/transcribe", b"RIFF")
        assert err.value.code == 404  # no batch service behind this server
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_serve_cli_wires_streaming(tmp_path, monkeypatch):
    """``cli.serve --streaming --decoder beam`` builds a beam session
    service sharing the batch service's model, then serves both."""
    from tpuasr_torch.cli import serve as serve_cli

    cfg, variables = _setup("gru")
    path = str(tmp_path / "uni.ckpt")
    ckpt.save_checkpoint(path, ckpt.CheckpointPackage(
        model_config=cfg, frontend_config=FrontendConfig(), labels=ABC.labels,
        variables=variables))
    seen = {}

    class Server:
        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    def fake_server(service, host, port, stream_service=None):
        seen.update(service=service, stream=stream_service)
        return Server()

    monkeypatch.setattr(serve_cli, "make_http_server", fake_server)
    assert serve_cli.main(["--model-path", path, "--streaming", "--decoder", "beam",
                           "--max-streams", "3", "--stream-chunk-frames", "16",
                           "--stream-beam-impl", "device", "--device", "cpu"]) == 0
    mst = seen["stream"]._mst
    assert mst.max_streams == 3 and mst.chunk_frames == 16 and mst.decoder == "beam"
    assert mst._dev_engine is not None and mst.model is seen["service"].model
    with pytest.raises(NotImplementedError, match="§1.5"):
        serve_cli.main(["--model-path", path, "--streaming", "--decoder", "beam",
                        "--stream-beam-impl", "native", "--device", "cpu"])


# ------------------------------------------------------------------- CLI

def test_transcribe_cli_streaming_matches_jax(tmp_path, capsys):
    """``cli.transcribe --streaming --offsets --stream-norm-stats`` prints
    what tpuasr's CLI prints on the same checkpoint (normalize on, so the
    causal statistics are primed from the manifest)."""
    from tpuasr.audio.frontend import FrontendConfig as JaxFrontendConfig
    from tpuasr.cli.transcribe import main as jax_main
    from tpuasr.model.ds2 import ModelConfig as JaxConfig
    from tpuasr.train import checkpoint as jax_ckpt
    from tpuasr_torch.cli.transcribe import main

    cfg, variables = _setup("gru")
    path = str(tmp_path / "uni.ckpt")
    jax_ckpt.save_checkpoint(path, jax_ckpt.CheckpointPackage(
        model_config=JaxConfig.from_dict(cfg.to_dict()),
        frontend_config=JaxFrontendConfig(), labels=ABC.labels, variables=variables))
    wav = str(tmp_path / "u.wav")
    wavfile.write(wav, 16000, (_wave(7, 21000) * 20000).astype(np.int16))
    manifest = tmp_path / "m.csv"
    manifest.write_text(f"{wav},{wav}.txt\n")
    args = ["--model-path", path, "--audio-path", wav, "--streaming", "--chunk-frames",
            "16", "--offsets", "--stream-norm-stats", str(manifest)]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    assert main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert len(want.splitlines()[0]) >= 2


def test_streaming_needs_a_gpu_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg, variables = _setup("gru")
    path = str(tmp_path / "uni.ckpt")
    ckpt.save_checkpoint(path, ckpt.CheckpointPackage(
        model_config=cfg, frontend_config=FrontendConfig(), labels=ABC.labels,
        variables=variables))
    for make in (lambda: StreamingTranscriber(variables, cfg, FrontendConfig(), ABC),
                 lambda: MultiStreamTranscriber(variables, cfg, FrontendConfig(), ABC),
                 lambda: StreamSessionService(path)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
