"""The port's serving slice vs tpuasr's, on the CPU, with a tiny f32
checkpoint that tpuasr wrote: eval step + greedy texts and offsets
equal tpuasr's; the service answers concurrent requests and HTTP; a
wave past the 16.5 s ladder goes through long-form decode exactly as
in tpuasr; the transcribe CLI prints tpuasr's text."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tpuasr.audio.frontend import FrontendConfig as JaxFrontendConfig
from tpuasr.data.buckets import BucketSpec as JaxBucketSpec
from tpuasr.decode.greedy import GreedyDecoder as JaxGreedy
from tpuasr.decode.longform import samples_per_frame as jax_spf
from tpuasr.decode.longform import transcribe_longform as jax_longform
from tpuasr.labels import Alphabet as JaxAlphabet
from tpuasr.model.ds2 import ModelConfig as JaxConfig
from tpuasr.train.checkpoint import CheckpointPackage as JaxPackage
from tpuasr.train.checkpoint import load_checkpoint as jax_load
from tpuasr.train.checkpoint import save_checkpoint as jax_save
from tpuasr.train.step import TrainConfig, init_train_state
from tpuasr.train.step import make_eval_step as jax_make_eval_step
from tpuasr_torch.compat.weights import model_from_variables
from tpuasr_torch.decode.greedy import GreedyDecoder
from tpuasr_torch.serve import ServeConfig, TranscriptionService, make_http_server
from tpuasr_torch.train.checkpoint import load_checkpoint
from tpuasr_torch.train.step import make_eval_step

SR = 16000
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    mc = JaxConfig(n_classes=JaxAlphabet().size, hidden_size=16,
                   hidden_layers=2, compute_dtype=jnp.float32)
    state = init_train_state(mc, TrainConfig(), jax.random.PRNGKey(4))
    path = str(tmp_path_factory.mktemp("torch_serve") / "m.ckpt")
    jax_save(path, JaxPackage(
        model_config=mc, frontend_config=JaxFrontendConfig(),
        labels=JaxAlphabet().labels,
        variables={"params": jax.device_get(state.params),
                   "batch_stats": jax.device_get(state.batch_stats)}))
    return path


@pytest.fixture(scope="module")
def jax_side(ckpt):
    pkg = jax_load(ckpt)
    variables = {"params": pkg.variables["params"],
                 "batch_stats": pkg.variables["batch_stats"]}
    return pkg, variables, jax_make_eval_step(pkg.model_config,
                                              pkg.frontend_config)


@pytest.fixture(scope="module")
def service(ckpt):
    svc = TranscriptionService(ckpt, ServeConfig(max_batch=4,
                                                 batch_window_ms=50.0),
                               device="cpu")
    yield svc
    svc.close()


def _waves(seed, sizes):
    rng = np.random.RandomState(seed)
    return [(0.2 * rng.randn(n)).astype(np.float32) for n in sizes]


def _batch(waves, bucket, dtype=np.float32):
    arr = np.zeros((len(waves), bucket), dtype)
    for j, w in enumerate(waves):
        arr[j, :len(w)] = w
    return arr, np.array([len(w) for w in waves], np.int32)


def _jax_decode(jax_side, arr, lens):
    pkg, variables, eval_step = jax_side
    logits, out_lengths = eval_step(variables, jnp.asarray(arr), jnp.asarray(lens))
    texts, offs = JaxGreedy(pkg.alphabet).decode(logits, out_lengths,
                                                 return_offsets=True)
    return np.asarray(logits), texts, [o.tolist() for o in offs]


def test_eval_step_and_greedy_match_jax(ckpt, jax_side):
    # int16 PCM rescaled on the device; ragged rows and an empty padding row
    waves = [(w * 32767).astype(np.int16) for w in _waves(0, [SR, 9000, 0, 4000])]
    arr, lens = _batch(waves, SR, np.int16)
    logits_j, texts_j, offs_j = _jax_decode(jax_side, arr, lens)
    pkg = load_checkpoint(ckpt)
    eval_step = make_eval_step(
        model_from_variables(pkg.variables, pkg.model_config, CPU),
        pkg.frontend_config)
    logits, out_lengths = eval_step(arr, lens)
    np.testing.assert_array_equal(out_lengths.numpy(), [51, 29, 1, 13])
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=2e-4, atol=2e-4)
    texts, offs = GreedyDecoder(pkg.alphabet).decode(logits, out_lengths,
                                                     return_offsets=True)
    assert texts == texts_j and [o.tolist() for o in offs] == offs_j
    assert any(texts)


def test_service_answers_concurrent_requests(service, jax_side):
    waves = _waves(1, [3000, 7000, 12000, 20000])
    results, errors = [None] * 4, []

    def call(j):
        try:
            results[j] = service.transcribe_wave(waves[j], timeout=120)
        except Exception as e:  # pragma: no cover
            errors.append(repr(e))

    threads = [threading.Thread(target=call, args=(j,)) for j in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errors and not any(t.is_alive() for t in threads)
    for w, (text, offsets) in zip(waves, results):
        bucket = JaxBucketSpec().bucket_samples(
            JaxBucketSpec().bucket_of(len(w) / SR))
        _, texts_j, offs_j = _jax_decode(jax_side, *_batch([w], bucket))
        assert (text, offsets) == (texts_j[0], offs_j[0])


def test_http_round_trip(service):
    server = make_http_server(service, "127.0.0.1", 0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        wave = _waves(2, [6000])[0]
        buf = io.BytesIO()
        wavfile.write(buf, SR, (wave * 32767).astype(np.int16))
        req = urllib.request.Request(f"http://127.0.0.1:{port}/transcribe",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        want = service.transcribe_wave(
            (wave * 32767).astype(np.int16).astype(np.float32) / 32768.0)
        assert (out["text"], out["offsets"]) == want
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/stream/open", data=b"",
                method="POST"), timeout=30)
        # no stream service behind this server: tpuasr's 400 "streaming
        # disabled" (tpuasr/serve.py:495-499)
        assert e.value.code == 400
        assert "streaming disabled" in json.loads(e.value.read())["error"]
    finally:
        server.shutdown()
        server.server_close()


def test_long_wave_matches_jax_longform(service, jax_side):
    pkg, variables, eval_step = jax_side
    wave = _waves(3, [int(17.3 * SR)])[0]
    want = jax_longform(eval_step, variables, wave, pkg.alphabet,
                        JaxBucketSpec(), JaxGreedy(pkg.alphabet),
                        batch_size=4, spf=jax_spf(pkg.frontend_config))
    text, offsets = service.transcribe_wave(wave, timeout=120)
    assert text and (text, offsets) == (want[0], want[1].tolist())


def test_transcribe_cli_prints_jax_text(ckpt, tmp_path, capsys):
    from tpuasr.cli.transcribe import main as jax_main
    from tpuasr_torch.cli.transcribe import main

    wav = str(tmp_path / "u.wav")
    wavfile.write(wav, SR, (_waves(4, [13000])[0] * 32767).astype(np.int16))
    args = ["--model-path", ckpt, "--audio-path", wav, "--offsets"]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    assert main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    with pytest.raises(NotImplementedError, match="not yet ported"):
        main(args + ["--device", "cpu", "--decoder", "beam-native"])


@pytest.mark.parametrize("long_audio", ["reject", "truncate"])
def test_long_audio_policies(ckpt, long_audio):
    svc = TranscriptionService(ckpt, ServeConfig(max_batch=2, long_audio=long_audio,
                                                 warmup_seconds=(0.5,)),
                               device="cpu")
    try:
        wave = _waves(5, [int(16.8 * SR)])[0]
        if long_audio == "reject":
            with pytest.raises(ValueError, match="serving cap"):
                svc.transcribe_wave(wave)
        else:
            cap = int(16.5 * SR)
            assert svc.transcribe_wave(wave, timeout=120) == \
                svc.transcribe_wave(wave[:cap], timeout=120)
    finally:
        svc.close()


def test_serve_cli_rejects_unported_modes(ckpt):
    from tpuasr_torch.cli.serve import main

    with pytest.raises(NotImplementedError, match="not yet ported"):
        main(["--model-path", ckpt, "--decoder", "beam-native", "--device", "cpu"])


def test_service_with_device_beam_matches_jax(ckpt, jax_side, monkeypatch):
    """TranscriptionService with DeviceBeamDecoder (word LM): its warm-up
    runs the beam search once per warmed bucket, and its answer equals
    tpuasr's device beam (XLA path) on the same wave."""
    import tpuasr_torch.ops.beam as beam_ops
    from tpuasr.decode.beam import DeviceBeamDecoder as JaxBeam
    from tpuasr.decode.lm import train_ngram as jax_train_ngram
    from tpuasr_torch.decode.beam import DeviceBeamDecoder
    from tpuasr_torch.decode.lm import train_ngram

    lines = ["ALO MUNDO", "BOM DIA", "TUDO BEM", "OLA MUNDO", "BOM DIA MUNDO"]
    calls = []
    scan = beam_ops.beam_scan
    monkeypatch.setattr(beam_ops, "beam_scan", lambda *a, **k: calls.append(1) or scan(*a, **k))
    pkg, variables, eval_step = jax_side
    kw = dict(beam_width=4, alpha=0.8, beta=1.0)
    svc = TranscriptionService(
        ckpt, ServeConfig(max_batch=2, warmup_seconds=(0.5, 1.5)),
        decoder=DeviceBeamDecoder(pkg.alphabet, word_lm=train_ngram(lines, order=2), **kw),
        device="cpu")
    try:
        assert len(calls) == 2
        wave = _waves(6, [11000])[0]
        text, offsets = svc.transcribe_wave(wave, timeout=120)
        assert len(calls) == 3
    finally:
        svc.close()
    bucket = JaxBucketSpec().bucket_samples(JaxBucketSpec().bucket_of(len(wave) / SR))
    arr, lens = _batch([wave], bucket)
    logits, out_lengths = eval_step(variables, jnp.asarray(arr), jnp.asarray(lens))
    jax_dec = JaxBeam(pkg.alphabet, word_lm=jax_train_ngram(lines, order=2), impl="xla", **kw)
    texts, offs = jax_dec.decode(logits, out_lengths, return_offsets=True)
    assert (text, offsets) == (texts[0], np.asarray(offs[0]).tolist())
