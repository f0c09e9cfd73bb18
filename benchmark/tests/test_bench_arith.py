"""The benchmark's own arithmetic, counted by hand: rate and tail, the
quartile spread, each roofline's operations and bytes, the idle share
and the naming of idle gaps."""

import statistics

import pytest

from benchmark import roofline, stats, trace, spec


def test_rate_and_tail_from_call_times():
    times = [t / 1000 for t in range(1, 101)]                       # 1 .. 100 ms
    assert stats.rate(131072 * len(times), sum(times)) == pytest.approx(131072 * 100 / 5.05)
    assert stats.p95(times) * 1e3 == pytest.approx(95.05)          # 1 + 0.95 * 99, linear between ranks
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_quartile_spread():
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx((4.5 - 1.5) / 3)
    assert stats.spread([10.0] * 6) == 0.0


@pytest.mark.parametrize("name, work, flops, nbytes", [
    ("alloc_rdo", roofline.alloc_rdo(1), 512 * 16 * 9 + 52 * 60, 2048 + 208 + 208),
    ("read_fields", roofline.read_fields(2), 0, 2 * (212 + 1092 * 4)),
    ("qmf_taps", roofline.qmf_taps(1), 768 * 48, 768 * 8),
    # two MDCT-256 (2816 ops, 1536 B), one MDCT-512 (6272, 3072), two spectra of 128 (4736, 768),
    # one of 256 (10752, 1536) and four short MDCT-64 (544, 384 each)
    ("fftjs", roofline.fftjs(1, 4), 2 * 2816 + 6272 + 2 * 4736 + 10752 + 4 * 544,
     2 * 1536 + 3072 + 2 * 768 + 1536 + 4 * 384),
])
def test_roofline_work_by_hand(name, work, flops, nbytes):
    assert work[0] == pytest.approx(flops) and work[1] == pytest.approx(nbytes)


def test_roofline_share_takes_the_larger_bound():
    flops, nbytes = 67e12, 3.35e12                                   # one second of each
    assert roofline.share((flops, nbytes / 2, "f32"), 2.0) == pytest.approx(50.0)
    assert roofline.share((flops / 4, nbytes, "f32"), 4.0) == pytest.approx(25.0)
    assert roofline.share((flops, nbytes, "f32"), 0.0) is None


def test_idle_share_from_synthetic_intervals():
    busy = trace.union([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)])
    assert busy == [(0.0, 2.0), (3.0, 4.0)]
    idle = trace.gaps(busy, 0.0, 5.0)
    assert idle == [(2.0, 3.0), (4.0, 5.0)]
    host = [(0.0, 5.0, "bench.call"), (2.2, 2.9, "aten::nonzero"), (1.9, 2.1, "aten::add")]
    assert trace.name_gaps(idle, host) == {"aten::nonzero": 1.0, "bench.call": 1.0}
    tr = trace.Trace(calls=2, wall_s=5.0, busy_s=3.0, busy_s_by_card=[3.0], device_ops=10, device_by_name={},
                     gaps_by_host={}, outputs=[])
    ctx = {"trace": tr, "op": "decode", "rows": 1, "frames": 1}
    assert spec.reader("idle_share.decode")(ctx) == pytest.approx(40.0)
    assert spec.reader("busy_ms_per_call.decode")(ctx) == pytest.approx(1500.0)
    assert spec.reader("launches_per_call.decode")(ctx) == pytest.approx(5.0)
    assert spec.reader("idle_share.encode")(ctx) is None


HOST = [(0.0, 5.0, "bench.call"), (2.2, 2.9, "aten::nonzero"), (1.9, 2.1, "aten::add"), (4.0, 5.0, "aten::cat")]


def test_per_card_busy_is_each_cards_union_and_their_mean():
    """Card 0 busy over [0, 2] and [3, 4], card 1 over [1, 3.5]: each card's
    union, idle named per card and summed, busy the mean, not the union."""
    device = [(0, 0.0, 1.0), (1, 1.0, 3.0), (0, 0.5, 2.0), (0, 3.0, 4.0), (1, 2.5, 3.5), (0, 3.5, 3.6)]
    busy, idle = trace.per_card(device, HOST, [0, 1])
    assert busy == pytest.approx([3.0, 2.5])
    # card 0 idles over [2, 3] (at 2.5: aten::nonzero) and [4, 5] (aten::cat); card 1 over [0, 1] (bench.call)
    # and [3.5, 5] (at 4.25: aten::cat)
    assert idle == pytest.approx({"aten::nonzero": 1.0, "aten::cat": 2.5, "bench.call": 1.0})
    tr = trace.Trace(2, 5.0, sum(busy) / 2, busy, len(device), {}, idle, [])
    assert tr.idle_pct() == pytest.approx(100 * (1 - 2.75 / 5))          # the cards' mean idle share
    assert trace.union([(s, e) for _, s, e in device]) == [(0.0, 4.0)]   # one card's reading would be 80% busy
    busy, _ = trace.per_card(device, HOST, [0, 1, 2])                    # a card of the cell with no work is idle
    assert busy == pytest.approx([3.0, 2.5, 0.0])


def test_one_card_reads_the_union():
    """On one card the per-card reduction is the union of every device
    interval and the gaps between them, as one card was always read."""
    intervals = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    busy, idle = trace.per_card([(0, s, e) for s, e in intervals], HOST, [0])
    merged = trace.union(intervals)
    assert busy == [sum(e - s for s, e in merged)]
    assert idle == trace.name_gaps(trace.gaps(merged, 0.0, 5.0), HOST)


def test_kernel_names_match_whole():
    assert trace.base_name("void (anonymous namespace)::qmf_taps_kernel<4>(float const*, float*)") == "qmf_taps_kernel"
    assert trace.base_name("(anonymous namespace)::mdct64_kernel(float const*, (anonymous namespace)::Tables16)") \
        == "mdct64_kernel"
    by_name = {"void imdct64_kernel(float const*)": 0.5, "mdct64_kernel(x)": 0.25}
    tr = trace.Trace(1, 1.0, 1.0, [1.0], 2, by_name, {}, [])
    assert tr.kernel_seconds(("mdct64_kernel",)) == 0.25


def test_roofline_readers_are_silent_without_their_kernel():
    tr = trace.Trace(1, 1.0, 1.0, [1.0], 2, {"other_kernel": 0.5}, {}, [])
    ctx = {"trace": tr, "op": "encode", "rows": 2, "frames": 16}
    for name in ("alloc_rdo_roofline", "read_fields_roofline", "qmf_taps_roofline", "fftjs_roofline"):
        assert spec.reader(name)(ctx) is None
    tr = trace.Trace(1, 1.0, 1.0, [1.0], 1, {"void (anonymous namespace)::alloc_rdo_kernel(float const*)": 1e-3},
                     {}, [])
    share = spec.reader("alloc_rdo_roofline")({"trace": tr, "op": "encode", "rows": 2, "frames": 16})
    least = max(2 * 16 * 76848 / 67e12, 2 * 16 * 2464 / 3.35e12)
    assert share == pytest.approx(100 * least / 1e-3)
    assert statistics.fmean([share]) < 100
