"""The metric arithmetic: the rate over whole images, the 95th percentile,
the device's idle share as a union of overlapping intervals, the attention
roofline and the image's share of the peak."""
from __future__ import annotations

import statistics

import pytest

from conftest import ROOT

from benchmark.harness import trace
from benchmark.harness.flops import PEAK_BF16_FLOPS, PEAK_BYTES, attention_least_s
from benchmark.harness.manifest import load_reader
from benchmark.harness.runner import RunRecord
from benchmark.harness.stats import percentile


def read(name, rec):
    return load_reader(name, ROOT / "benchmark")(rec)


def test_rate_over_whole_images():
    rec = RunRecord("c", 45.0, 10.0, window_s=40.0, images_ok=4)
    assert read("img_per_min", rec) == pytest.approx(6.0)
    assert read("img_per_min", RunRecord("c", 45.0, 10.0)) is None


def test_percentile():
    v = [float(i) for i in range(1, 101)]
    assert percentile(v, 95) == pytest.approx(statistics.quantiles(v, n=100,
                                                                 method="inclusive")[94])
    assert percentile(v, 95) == pytest.approx(95.05)
    assert read("step_ms_p95", RunRecord("c", 45, 1, step_ms=v)) == pytest.approx(95.05)
    assert read("step_ms_p95", RunRecord("c", 45, 1, step_ms=v[:5])) is None


def test_union_of_overlapping_intervals():
    ops = [trace.Op("a", 0, 10), trace.Op("b", 5, 15), trace.Op("c", 20, 30),
           trace.Op("d", 22, 25), trace.Op("e", 95, 120)]
    assert trace.union([(o.start, o.end) for o in ops]) == [(0, 15), (20, 30), (95, 120)]
    assert trace.busy_ns(ops, 0, 100) == 15 + 10 + 5
    assert trace.idle_gaps(ops, 0, 100) == [(15, 20), (30, 95)]
    summary = trace.TraceSummary(busy_s=30e-9, window_s=100e-9, device_ops=[], idle_gaps=[],
                                 attn_device_s={})
    assert read("device_idle", RunRecord("c", 45, 1, summary=summary)) == pytest.approx(70.0)


def test_summary_labels_gaps_and_attributes_attention():
    ops = [trace.Op("flash_fm_kernel", 100, 200, launch=50),
           trace.Op("elementwise_kernel", 210, 220, launch=60),
           trace.Op("gemm", 400, 500, launch=300)]
    ranges = [trace.Range(trace.IMAGE_RANGE, 0, 600),
              trace.Range(trace.STAGE_PREFIX + "sampling", 10, 350),
              trace.Range(trace.STAGE_PREFIX + "decode", 350, 590),
              trace.Range(trace.ATTN_PREFIX + "0", 40, 70)]
    s = trace.summarize(trace.Trace(ops, ranges))
    assert s.busy_s == pytest.approx(210e-9)
    assert s.window_s == pytest.approx(600e-9)
    assert s.attn_device_s == {0: pytest.approx(110e-9)}
    assert s.idle_gaps[0] == ("sampling", pytest.approx(180e-9))     # 220 .. 400
    assert dict(s.idle_gaps)["decode"] == pytest.approx(100e-9)        # 500 .. 600
    assert trace.summarize(trace.Trace([], ranges)) is None


def test_device_busy_between_markers():
    ops = [trace.Op("fill", 0, 2), trace.Op("a", 10, 40), trace.Op("b", 30, 60),
           trace.Op("fill", 98, 100)]
    busy, window = trace.device_busy(trace.Trace(ops, []))
    assert busy == pytest.approx(54e-9) and window == pytest.approx(100e-9)
    assert trace.device_busy(trace.Trace(ops[:2], [])) is None


def test_attention_roofline_and_mfu():
    B, H, L, D = 10, 8, 6144, 40
    ops = 4.0 * B * H * L * L * D
    assert attention_least_s(B, H, L, L, D, 2) == pytest.approx(ops / PEAK_BF16_FLOPS)
    small = attention_least_s(2, 8, 64, 77, 40, 2)
    assert small == pytest.approx(2 * 2 * 8 * 40 * (2 * 64 + 2 * 77) / PEAK_BYTES)
    rec = RunRecord("c", 45, 1, attn_calls=[trace.AttnCall(B, H, L, L, D, 2)],
                    summary=trace.TraceSummary(1.0, 2.0, [], [], {0: 2 * ops / PEAK_BF16_FLOPS}))
    assert read("attn_roofline", rec) == pytest.approx(50.0)
    rec = RunRecord("c", 45, 1, window_s=60.0, images_ok=6, image_flops=PEAK_BF16_FLOPS)
    assert read("image_mfu", rec) == pytest.approx(10.0)
