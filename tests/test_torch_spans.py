"""The chunk step's stage spans (`carta1_tpu_torch.profiling.span`), on the CPU.

Each engine's encode step and the decode step run under a CPU
`torch.profiler`: the spans form the documented tree, once per call;
every operation of a step lies in one stage but for the conversions at
its ends; the spans are host events of the profiler's own trace, nested
as the tree; they change no output; the decode counts its short
band-frames.  With no profiler a step records nothing.

Imports neither JAX nor the JAX package, so on a GPU machine without JAX
the card's case (marked `cuda`: no device operation carries a span's
name, the spans add none, the stages' device times add up to the step's)
runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py
"""

import collections

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from carta1_tpu_torch import profiling, processor
from carta1_tpu_torch.ops.bitpack import unpack_frames
from carta1_tpu_torch.ops.pcm import float_to_int16, int16_to_float
from carta1_tpu_torch.options import EncoderOptions
from carta1_tpu_torch.pipeline.decoder import decoder_init_state
from carta1_tpu_torch.pipeline.encoder import encoder_init_state

CPU = torch.device("cpu")
OPTS = EncoderOptions()
ROWS, FRAMES = 2, 16
STEPS = ["tpu", "exact", "decode"]            # the two encode engines and the decoder

# each span's parent, per operation
TREE = {
    "encode": {
        "carta1.encode.step": None,
        "carta1.encode.analysis": "carta1.encode.step",
        "carta1.encode.qmf": "carta1.encode.analysis",
        "carta1.encode.transient": "carta1.encode.analysis",
        "carta1.encode.mdct": "carta1.encode.analysis",
        "carta1.encode.scale_factors": "carta1.encode.analysis",
        "carta1.encode.allocate": "carta1.encode.step",
        "carta1.encode.quantize": "carta1.encode.step",
        "carta1.encode.pack": "carta1.encode.step",
    },
    "decode": {
        "carta1.decode.step": None,
        "carta1.decode.unpack": "carta1.decode.step",
        "carta1.decode.dequantize": "carta1.decode.step",
        "carta1.decode.imdct": "carta1.decode.step",
        "carta1.decode.short_index": "carta1.decode.imdct",
        "carta1.decode.synthesis": "carta1.decode.step",
    },
}
# the stages: every launch of a step lies in one, but for the step's conversions
LEAVES = {
    "encode": {"carta1.encode.qmf", "carta1.encode.transient", "carta1.encode.mdct", "carta1.encode.scale_factors",
               "carta1.encode.allocate", "carta1.encode.quantize", "carta1.encode.pack"},
    "decode": {"carta1.decode.unpack", "carta1.decode.dequantize", "carta1.decode.imdct", "carta1.decode.synthesis"},
}


def op_of(kind: str) -> str:
    return "decode" if kind == "decode" else "encode"


def drums(rows: int, frames: int, seed: int) -> torch.Tensor:
    """int16 [rows, frames, 512]: a low tone under a decaying noise burst at
    every other frame start, so that many band-frames are short."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames * 512) / 44100.0
    x = 0.2 * np.sin(2 * np.pi * 110 * t)[None, :] + 0.01 * rng.standard_normal((rows, frames * 512))
    env = np.exp(-np.arange(512) / 60.0)
    for f in range(0, frames, 2):
        x[:, f * 512:(f + 1) * 512] += 0.6 * env * rng.standard_normal((rows, 512))
    return torch.from_numpy((np.clip(x, -1, 1) * 32767).astype(np.int16).reshape(rows, frames, 512))


@pytest.fixture(scope="module")
def inputs():
    """Two chunks of int16 frames, and their units from the batched engine."""
    frames = [drums(ROWS, FRAMES, 5), drums(ROWS, FRAMES, 6)]
    state, units = None, []
    for f in frames:
        u, state = processor._encode_batch_dev(f, OPTS, state)
        units.append(u)
    return {"encode": frames, "decode": units}


@pytest.fixture(scope="module")
def profiled(inputs):
    """kind -> (output, the profiler's events) of one call from the zero
    state under a CPU profiler, made once per kind."""
    made = {}

    def get(kind: str):
        if kind not in made:
            with cpu_profile() as prof:
                y, _ = step(kind, inputs[op_of(kind)][0], None)
            made[kind] = (y, prof.events())
        return made[kind]
    return get


def step(kind: str, x: torch.Tensor, state):
    if kind == "decode":
        return processor._decode_batch_dev(x, state, to_i16=True)
    return processor._encode_batch_dev(x, OPTS, state, engine=kind)


def run_calls(kind: str, chunks: list) -> list:
    """Each chunk through the step with the state carried: [(output, state)]."""
    out, state = [], None
    for x in chunks:
        y, state = step(kind, x, state)
        out.append((y, state))
    return out


def cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def new_records(before: list) -> list:
    last = before[-1]["id"] if before else -1
    return [r for r in profiling.spans() if r["id"] > last]


def span_of(ev):
    """The innermost span event enclosing a profiler event, or None."""
    ev = ev.cpu_parent
    while ev is not None and not ev.name.startswith("carta1."):
        ev = ev.cpu_parent
    return ev


def top_level_ops(fn) -> collections.Counter:
    """The names of the outermost operations `fn()` runs."""
    with cpu_profile() as prof:
        fn()
    return collections.Counter(e.name for e in prof.events() if e.cpu_parent is None)


@pytest.mark.parametrize("kind", STEPS)
def test_no_profiler_records_nothing(kind, inputs):
    before = profiling.spans()
    run_calls(kind, inputs[op_of(kind)])
    after = profiling.spans()
    assert len(after) == len(before) and after[-1:] == before[-1:]
    assert profiling.span("carta1.test") is profiling.span("carta1.test", inputs["encode"][0])


@pytest.mark.parametrize("kind", STEPS)
def test_each_call_gives_the_span_tree(kind, inputs):
    op = op_of(kind)
    before = profiling.spans()
    with cpu_profile():
        run_calls(kind, inputs[op])
    records = new_records(before)
    by_id = {r["id"]: r for r in records}
    steps = [r for r in records if r["parent"] is None]
    assert [r["name"] for r in steps] == [f"carta1.{op}.step"] * len(inputs[op])
    for s in steps:
        mine = [r for r in records if r["call"] == s["id"]]
        assert sorted(r["name"] for r in mine) == sorted(TREE[op])
        for r in mine:
            want = TREE[op][r["name"]]
            assert (by_id[r["parent"]]["name"] if r["parent"] is not None else None) == want
            assert r["host_ms"] > 0 and r["device_ms"] is None          # a step on the CPU has no device time
    assert len(records) == len(steps) * len(TREE[op])


@pytest.mark.parametrize("kind", STEPS)
def test_every_operation_lies_in_a_stage(kind, inputs, profiled):
    """Every aten operation of a call lies inside a stage's span, but for the
    outermost operations of the step's conversions: a new zero state and
    int16 -> f32 at entry, f32 -> int16 at the decode's exit."""
    op = op_of(kind)
    x = inputs[op][0]
    y, events = profiled(kind)
    outside = collections.Counter()
    for ev in events:
        if not ev.name.startswith("aten::"):
            continue
        sp = span_of(ev)
        while sp is not None and sp.name == "carta1.decode.short_index":
            sp = span_of(sp)
        assert sp is not None, ev.name
        if sp.name == f"carta1.{op}.step":
            if ev.cpu_parent is sp:
                outside[ev.name] += 1
        else:
            assert sp.name in LEAVES[op], (ev.name, sp.name)
    if op == "encode":
        want = top_level_ops(lambda: (encoder_init_state(CPU, ROWS), int16_to_float(x)))
    else:
        pcm = y.to(torch.float32) / 32768
        want = top_level_ops(lambda: (decoder_init_state(CPU, ROWS), float_to_int16(pcm)))
    assert outside == want


@pytest.mark.parametrize("kind", STEPS)
def test_spans_are_host_events_of_the_trace(kind, profiled):
    op = op_of(kind)
    events = [e for e in profiled(kind)[1] if e.name.startswith("carta1.")]
    assert collections.Counter(e.name for e in events) == collections.Counter(list(TREE[op]))
    for e in events:
        assert e.device_type == torch.autograd.DeviceType.CPU
        up = span_of(e)
        assert (up.name if up is not None else None) == TREE[op][e.name]
        if up is not None:
            assert up.time_range.start <= e.time_range.start <= e.time_range.end <= up.time_range.end


@pytest.mark.parametrize("kind", STEPS)
def test_spans_change_no_output(kind, inputs):
    chunks = inputs[op_of(kind)]
    off = run_calls(kind, chunks)
    with cpu_profile():
        on = run_calls(kind, chunks)
    for (y0, s0), (y1, s1) in zip(off, on):
        assert y0.dtype == y1.dtype and torch.equal(y0, y1)
        assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_decode_counts_its_short_band_frames(inputs):
    units = inputs["decode"]
    before = profiling.spans()
    with cpu_profile():
        run_calls("decode", units)
    got = sum(r["counts"]["short_band_frames"] for r in new_records(before)
              if r["name"] == "carta1.decode.short_index")
    want = sum(int((unpack_frames(u).block_modes != 0).sum()) for u in units)
    assert got == want > 0


def test_buffer_keeps_the_newest_records():
    with cpu_profile():
        for _ in range(profiling.SPAN_BUFFER + 7):
            with profiling.span("carta1.test") as sp:
                sp.add("n", 1)
        with profiling.span("carta1.test.last"):
            pass
    records = profiling.spans()
    assert len(records) == profiling.SPAN_BUFFER
    assert records[-1]["name"] == "carta1.test.last"
    assert [r["id"] for r in records] == sorted(r["id"] for r in records)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step's kernels and the spans' events have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", STEPS)
def test_card_spans_add_no_device_work(card, kind, monkeypatch):
    """On the card, at a benchmark cell's size (16 rows x 8,192 frames), with
    the state carried and no conversion at the step's ends: no device
    operation carries a span's name; the spans add no kind of device
    operation, and no profiled run with them counts more than the most of
    the runs with their gate forced off (a step's count can differ by one
    from one profiled run to the next with no span at all: the exact cell
    read 863.83 and 864 a call, either way); and the stages' device times
    add up to the step's within 3%."""
    op = op_of(kind)
    g = torch.Generator(device=card).manual_seed(3)
    pcm = (torch.rand((16, 8192, 512), generator=g, device=card) - 0.5) * 0.5
    if op == "decode":
        x, state = processor._encode_batch_dev(pcm, OPTS, None)[0], decoder_init_state(card, 16)
        run = lambda: processor._decode_batch_dev(x, state)  # noqa: E731
    else:
        x, state = pcm, encoder_init_state(card, 16)
        run = lambda: processor._encode_batch_dev(x, OPTS, state, engine=kind)  # noqa: E731
    run()
    torch.cuda.synchronize(card)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    device_ops = {True: [], False: []}
    for gate in (False, True, False, True):
        before = profiling.spans()
        with torch.profiler.profile(activities=acts) as prof:
            if not gate:
                monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", False)
            run()
            torch.cuda.synchronize(card)
            monkeypatch.undo()
        ops = collections.Counter(e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        assert not [name for name in ops if name.startswith("carta1.")]
        device_ops[gate].append(ops)
        records = new_records(before)
        if not gate:
            assert records == []
            continue
        step_ms = sum(r["device_ms"] for r in records if r["name"] == f"carta1.{op}.step")
        leaves_ms = sum(r["device_ms"] for r in records if r["name"] in LEAVES[op])
        assert step_ms > 0 and abs(leaves_ms - step_ms) <= 0.03 * step_ms, (leaves_ms, step_ms)
    on, off = device_ops[True], device_ops[False]
    assert set().union(*on) <= set().union(*off), [dict(a - b) for a in on for b in off]
    assert 0 < max(sum(c.values()) for c in on) <= max(sum(c.values()) for c in off), (
        [sum(c.values()) for c in on], [sum(c.values()) for c in off])
