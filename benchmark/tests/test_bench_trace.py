"""The trace readers on a synthetic Chrome trace."""

import json

import pytest

from benchmark.lib.trace import WINDOW_SPAN, load_events, window_summary


def synthetic(path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW_SPAN, "ts": 1000, "dur": 1000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1000, "dur": 150},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 1390, "dur": 300},
        {"ph": "X", "cat": "kernel", "name": "rnn_fwd_loop<bf16>", "ts": 900, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "gemm_a", "ts": 1150, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "gemm_b", "ts": 1200, "dur": 200},  # overlaps
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1700, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "rnn_fwd_loop<bf16>", "ts": 1900, "dur": 200},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1500},
    ]
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_window_summary(tmp_path):
    s = window_summary(load_events(synthetic(tmp_path / "t.json")))
    assert s["window_s"] == pytest.approx(1000e-6)
    # busy, clipped to the window: 1000-1100, 1150-1400, 1700-1750, 1900-2000
    assert s["busy_s"] == pytest.approx(500e-6)
    assert s["by_name"]["rnn_fwd_loop<bf16>"] == pytest.approx(200e-6)
    assert s["device_ops"][0][0] in ("rnn_fwd_loop<bf16>", "gemm_b")
    idle = dict(s["idle_gaps"])
    # 1100-1150 under aten::mm; 1400-1700 under aten::item; 1750-1900 none
    assert idle["aten::mm"] == pytest.approx(50e-6)
    assert idle["aten::item"] == pytest.approx(300e-6)
    assert idle["host_python"] == pytest.approx(150e-6)


def test_window_summary_needs_the_span(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 5}]}))
    with pytest.raises(ValueError):
        window_summary(load_events(path))
