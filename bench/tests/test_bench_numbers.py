"""Percentiles, spreads, the work formulas, step_mfu, rooflines and the
idle share against hand-worked values and a synthetic profiler trace."""

import math

import pytest

from benchlib import files, stats, work
from benchlib import trace as TR
from benchlib.cell import Record, Window

GRANITE = work.Shape.of(files.load_json(
    files.BENCH_DIR / "configs" / "granite-8b.json")["model"])


def test_percentiles_and_spread():
    xs = [5, 1, 4, 2, 3]
    assert stats.percentile(xs, 50) == 3
    assert stats.percentile(xs, 90) == pytest.approx(4.6)
    assert stats.percentile(list(range(101)), 95) == 95
    assert stats.percentile([], 90) is None
    # statistics.quantiles([1..8], n=4) -> 2.25, 4.5, 6.75
    assert stats.spread(range(1, 9)) == pytest.approx(4.5 / 4.5)


def test_granite_widths_by_hand():
    # q, k, v, o: 4096 * 128 * (2 * 32 + 2 * 8); swiglu: 3 * 4096 * 14336
    assert GRANITE.layer_matmul_params == 4096 * 128 * 80 + 3 * 4096 * 14336
    f = work.token_flops(GRANITE, 1000, logits=True)
    assert f == 36 * (2 * GRANITE.layer_matmul_params
                      + 4 * 1000 * 32 * 128) + 2 * 4096 * 49152
    # a prefill of 3 tokens after 2 cached reads 3 + 4 + 5 positions
    assert work.prefill_flops(GRANITE, 2, 3) == 36 * (
        2 * GRANITE.layer_matmul_params * 3 + 4 * 12 * 32 * 128)
    assert work.decode_flops(GRANITE, 2, 10) == (
        work.token_flops(GRANITE, 4, logits=True)
        + work.token_flops(GRANITE, 6, logits=True))


def test_k1_bound_by_hand():
    # four rows over one shared 8192-position context read it once
    assert work.paged_attention_bound_s(GRANITE, 4, 1, 4 * 8192, 8192 + 4) \
        == pytest.approx(36 * ((8192 + 4) * 8 * 128 * 4 + 4 * 32 * 128 * 4)
                         / 3.35e12)
    # decode: 96 rows reading 8192 positions each, bytes-bound
    s = work.paged_attention_bound_s(GRANITE, 96, 1, 96 * 8192)
    kv = 96 * 8192 * 8 * 128 * 2 * 2
    qo = 96 * 32 * 128 * 2 * 2
    assert s == pytest.approx(36 * (kv + qo) / 3.35e12)
    # a 1024-token suffix over 8192 cached positions is FLOP-bound
    s = work.paged_attention_bound_s(GRANITE, 1, 1024, 8192 + 1024)
    reads = sum(8192 + i + 1 for i in range(1024))
    assert s == pytest.approx(36 * 4 * reads * 32 * 128 / 989e12)


def _window(**kw):
    base = dict(shape=GRANITE, chips=1, on_card=True, setup_s=1.0,
                t_open=0, t_close=2_000_000_000, turns=[], rec=Record(),
                counters={})
    base.update(kw)
    return Window(**base)


def test_step_mfu_by_hand():
    # over the traced stretch: [0, 2 s)
    rec = Record()
    rec.decodes = [(10, 100, 4, 4000, 0),
                   (3_000_000_000, 3_000_000_100, 9, 9, 0)]
    rec.prefills = [(50, 60, 0, 2048), (-5, 0, 0, 999)]
    run = _window(rec=rec, stretch=(0, 2_000_000_000))
    flops = (work.decode_flops(GRANITE, 4, 4000)
             + work.prefill_flops(GRANITE, 0, 2048))
    reader = files.metric_reader("step_mfu.tok")
    assert reader.read(run) == pytest.approx(100 * flops / (2.0 * 989e12))
    assert reader.read(_window(rec=rec, on_card=False)) is None
    assert reader.read(_window(rec=rec)) is None       # untraced


def synthetic():
    """A stretch of 1000 ns on the device's clock (its markers end at 100
    and start at 1100), host spans 5000 ns behind it: kernels over [200,
    400) (two overlapping) and [700, 800); idle [100, 200) in driver.step,
    [400, 700) in engine.decode, [800, 1100) outside any span."""
    ev = [TR.Event("spin_kernel(long)", 90, 100),
          TR.Event("paged_tc_kernel<1>", 200, 350),
          TR.Event("gemm", 300, 400),
          TR.Event("paged_tc_kernel<1>", 700, 800),
          TR.Event("spin_kernel(long)", 1100, 1110),
          TR.Event("gemm", 1500, 1600)]          # after the stretch
    spans = [("driver.step", -4910, -4250), ("engine.decode", -4650, -4260)]
    return ev, spans, -5000 + 90


def test_idle_share_and_breakdown():
    ev, spans, host0 = synthetic()
    tr = TR.reduce(ev, 1, spans, host0, host0 + 1000)
    assert tr["window_s"] == pytest.approx(1000e-9)
    assert tr["busy_s"] == pytest.approx(300e-9)
    assert dict((n, s) for n, s in tr["idle_gaps"]) == pytest.approx(
        {"driver.step": 100e-9, "engine.decode": 300e-9,
         "harness": 300e-9})
    assert tr["device_ops"][0] == ["paged_tc_kernel<1>",
                                   pytest.approx(250e-9)]
    run = _window(trace=tr)
    idle = files.metric_reader("device_idle_share.tok").read(run)
    assert idle == pytest.approx(70.0)
    assert TR.kernel_s(tr, "paged_tc") == pytest.approx(250e-9)
    # a second card that ran nothing halves the busy share
    assert TR.reduce(ev, 2, spans, host0, host0 + 1000)["busy_s"] == \
        pytest.approx(150e-9)
    assert TR.reduce([], 1, spans, host0, host0 + 1000) is None


def test_a_lost_marker_is_stood_in_for():
    ev, spans, host0 = synthetic()
    full = TR.reduce(ev, 1, spans, host0, host0 + 1000)
    for lost in (ev[0], ev[4]):
        part = TR.reduce([e for e in ev if e is not lost], 1, spans, host0,
                         host0 + 1000)
        assert part["busy_s"] == pytest.approx(full["busy_s"], rel=0.05)
        assert part["window_s"] == pytest.approx(1000e-9)
    # both lost: the first launch after the warm-up's gap opens it
    warm = [TR.Event("add", -10_000_000, -9_999_000)]
    both = TR.reduce(warm + ev[1:4], 1, spans, host0, host0 + 1000)
    assert both["window_s"] == pytest.approx(1000e-9)
    assert both["busy_s"] == pytest.approx(300e-9)


def test_nested_spans_charge_the_innermost():
    spans = sorted([("driver.step", 0, 100), ("engine.add_request", 10, 50),
                    ("engine.prefill.suffix", 10, 40),
                    ("engine.decode", 60, 90)], key=lambda x: (x[1], -x[2]))
    assert TR._hosts_at(spans, [5, 10, 45, 55, 70, 95, 120]) == [
        "driver.step", "engine.prefill.suffix", "engine.add_request",
        "driver.step", "engine.decode", "driver.step", "harness"]


def test_k1_roofline_reads_the_stretch_only():
    tr = {"device_s": {"paged_tc_kernel<x>": 0.002, "gemm": 1.0},
          "busy_s": 1.0, "window_s": 2.0}
    rec = Record()
    # 96 branches of 24 contexts, 4 forks each: each page read once
    rec.decodes = [(10, 20, 96, 96 * 8192, 24 * 8192 + 96),
                   (5000, 6000, 96, 1, 0)]
    rec.prefills = [(30, 40, 8192, 1024), (50, 60, 0, 4096)]
    run = _window(rec=rec, trace=tr, stretch=(0, 100))
    bound = (work.paged_attention_bound_s(GRANITE, 96, 1, 96 * 8192,
                                          24 * 8192 + 96)
             + work.paged_attention_bound_s(GRANITE, 1, 1024, 9216))
    got = files.metric_reader("k1_roofline.tok").read(run)
    assert got == pytest.approx(100 * bound / 0.002)
    del tr["device_s"]["paged_tc_kernel<x>"]
    assert files.metric_reader("k1_roofline.tok").read(run) is None


def test_latency_readers():
    rec = Record()
    rec.decodes = [(0, 5_000_000_000, 1, 1, 0)]
    rec.gaps = [(t, g) for t, g in zip(range(10, 110, 10),
                                       range(1_000_000, 11_000_000,
                                             1_000_000))]
    rec.gaps.append((3_000_000_000, 10 ** 9))     # after the close
    run = _window(rec=rec)
    assert files.metric_reader("itl_p95_ms").read(run) == \
        pytest.approx(stats.percentile(range(1, 11), 95))
    assert math.isclose(files.metric_reader("explore_tok_s").read(
        _window(rec=Record(decodes=[(0, 10, 96, 1, 0)] * 4))), 4 * 96 / 2.0)


def test_two_cards_busy_and_idle_are_means():
    # card 0 busy [200, 400) and [700, 800) as above; card 1 [100, 600)
    ev, spans, host0 = synthetic()
    ev = ev + [TR.Event("gemm", 100, 600, index=1)]
    tr = TR.reduce(ev, 2, spans, host0, host0 + 1000)
    assert tr["busy_s"] == pytest.approx((300e-9 + 500e-9) / 2)
    assert tr["busy_by_card"] == pytest.approx({0: 300e-9, 1: 500e-9})
    assert sum(s for _, s in tr["idle_gaps"]) == pytest.approx(
        tr["window_s"] - tr["busy_s"])
    # card 1's idle [600, 1100) began inside engine.decode
    assert dict(tr["idle_gaps"]) == pytest.approx(
        {"driver.step": 100e-9 / 2, "engine.decode": (300e-9 + 500e-9) / 2,
         "harness": 300e-9 / 2})
    idle = files.metric_reader("device_idle_share.tok").read(
        _window(trace=tr, chips=2))
    assert idle == pytest.approx(60.0)
    # four cards of which two ran nothing: each idle card counts whole
    four = TR.reduce(ev, 4, spans, host0, host0 + 1000)
    assert four["busy_s"] == pytest.approx(800e-9 / 4)
    assert sum(s for _, s in four["idle_gaps"]) == pytest.approx(
        1000e-9 - 800e-9 / 4)


def _k1_trace(cards, kernel_ns):
    """A 2 s stretch in which each of ``cards`` ran K1 for ``kernel_ns``."""
    ev = [TR.Event("spin_kernel", 0, 10),
          TR.Event("spin_kernel", 2 * 10 ** 9 + 10, 2 * 10 ** 9 + 20)]
    ev += [TR.Event("paged_tc_kernel<128>", 100, 100 + kernel_ns, index=c)
           for c in range(cards)]
    return TR.reduce(ev, cards, [], 0, 2 * 10 ** 9)


def test_k1_roofline_over_shards_counts_the_work_once():
    # the same rows at tp 1 and at tp 4: a card of four reads a quarter of
    # the kv heads, so each runs K1 a quarter as long, and the device time
    # summed over the cards is tp 1's
    rec = Record()
    rec.decodes = [(10, 20, 32, 32 * 4096, 8 * 4096 + 32)]
    bound = work.paged_attention_bound_s(GRANITE, 32, 1, 32 * 4096,
                                         8 * 4096 + 32)
    one = _k1_trace(1, int(4 * bound * 1e9))
    four = _k1_trace(4, int(bound * 1e9))
    reader = files.metric_reader("k1_roofline.tok")
    at1 = reader.read(_window(rec=rec, trace=one, stretch=(0, 100)))
    at4 = reader.read(_window(rec=rec, trace=four, stretch=(0, 100),
                              chips=4))
    assert at1 == pytest.approx(25.0, rel=1e-6)
    assert at4 == pytest.approx(at1, rel=1e-6)
    # step_mfu divides by every card's peak; every share stays under 100%
    mfu = files.metric_reader("step_mfu.tok")
    m1 = mfu.read(_window(rec=rec, stretch=(0, 2 * 10 ** 9)))
    m4 = mfu.read(_window(rec=rec, stretch=(0, 2 * 10 ** 9), chips=4))
    assert m4 == pytest.approx(m1 / 4)
    idle = files.metric_reader("device_idle_share.tok")
    for share in (at1, at4, m1, m4, idle.read(_window(trace=four, chips=4))):
        assert 0 < share <= 100
