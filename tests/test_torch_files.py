"""The port's file layer against the JAX package's, on the CPU.

Streaming WAV/AEA IO, `encode_file` / `decode_file` with checkpoint and
resume, `encode_clips`, the profiling hooks and the CLI.  The references
are the JAX package's host code only (its gold `engine="exact"`, its
streams, WAV and AEA modules, its CLI with the exact engine), so nothing
here compiles a JAX program.  Inputs are made from a seed with NumPy.  The
same entry points on the card: tests/test_torch_kernels_cuda.py and
chip_smoke.py phase 9.
"""

import dataclasses
import json
import os
import re
import runpy
import sys
import warnings

import numpy as np
import pytest
import torch

from carta1_tpu import cli as jax_cli
from carta1_tpu import processor as jax_processor
from carta1_tpu.framedata import FrameData as JaxFrameData
from carta1_tpu.io import aea as jax_aea
from carta1_tpu.io import streams as jax_streams
from carta1_tpu.io import wav as jax_wav
from carta1_tpu.io.bitstream_np import unpack_frames as jax_unpack
from carta1_tpu.profiling import stream_stats as jax_stream_stats

import carta1_tpu_torch as port
from carta1_tpu_torch import cli, profiling
from carta1_tpu_torch.io import aea, streams, wav
from carta1_tpu_torch.ops.bitpack import unpack_frames
from carta1_tpu_torch.processor import _encode_batch_dev

CHUNK = 16                                   # several chunks over a 0.4 s file
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
GOLDEN = os.path.join(FIXTURES, "golden.aea")


@pytest.fixture(autouse=True, scope="module")
def _no_native_build():
    """The JAX package's host packers in NumPy: no C++ build on first use."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CARTA1_NO_NATIVE", "1")
        yield


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _stereo_i16(seconds=0.4, seed=0) -> np.ndarray:
    """Noise with a burst (short blocks), a length that is no multiple of 512."""
    rng = np.random.default_rng(seed)
    n = int(44100 * seconds) + 77
    x = rng.standard_normal((2, n)) * 0.2
    x[:, n // 3: n // 3 + 300] += 0.5
    return jax_wav.float_to_int16(x.astype(np.float32))


def _wav_bytes(samples: np.ndarray, bits: int, extensible: bool = False) -> bytes:
    """A WAV file of integer samples [channels, n] at 16, 24 or 32 bits, with
    a chunk the readers must skip before the data."""
    c, n = samples.shape
    inter = samples.T.reshape(-1).astype("<i4")
    if bits == 16:
        data = inter.astype("<i2").tobytes()
    elif bits == 32:
        data = inter.tobytes()
    else:
        data = inter.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    fmt = np.array([0xFFFE if extensible else 1, c], "<u2").tobytes() + np.array(
        [44100, 44100 * c * bits // 8], "<u4").tobytes() + np.array([c * bits // 8, bits], "<u2").tobytes()
    if extensible:
        fmt += b"\x16\x00" + b"\x00" * 22
    body = b"WAVE" + b"fmt " + len(fmt).to_bytes(4, "little") + fmt + b"LIST" + (3).to_bytes(4, "little") + b"abc\x00"
    body += b"data" + len(data).to_bytes(4, "little") + data
    return b"RIFF" + len(body).to_bytes(4, "little") + body


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A stereo int16 WAV, its AEA and its decoded WAV, each made once by the port on the CPU."""
    d = tmp_path_factory.mktemp("files")
    i16 = _stereo_i16()
    paths = {k: str(d / k) for k in ("in.wav", "port.aea", "port.wav", "jax.aea")}
    wav.write_wav(paths["in.wav"], i16)
    timings = {}
    res = port.encode_file(paths["in.wav"], paths["port.aea"], title="t", chunk_frames=CHUNK, device="cpu",
                           timings=timings)
    port.decode_file(paths["port.aea"], paths["port.wav"], chunk_frames=CHUNK, device="cpu")
    jax_processor.encode_file(paths["in.wav"], paths["jax.aea"], engine="exact", title="t", chunk_frames=CHUNK)
    return {"dir": d, "i16": i16, "result": res, "timings": timings, **paths}


class _KillAt:
    """Progress callback that raises after a set number of calls
    (tests/test_streaming_io.py)."""

    def __init__(self, after):
        self.after = after
        self.calls = 0

    def __call__(self, done, total):
        self.calls += 1
        if self.calls >= self.after:
            raise KeyboardInterrupt("simulated kill")


# ---------------------------------------------------------------------------
# host IO
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits,extensible", [(16, False), (24, True), (32, False)])
def test_wav_readers_bitwise_equal_jax(tmp_path, bits, extensible):
    rng = np.random.default_rng(bits)
    lim = 1 << (bits - 1)
    samples = rng.integers(-lim, lim, (2, 3 * 512 + 100), dtype=np.int64)
    samples[:, :2] = [[-lim, lim - 1], [0, -1]]
    path = str(tmp_path / "in.wav")
    with open(path, "wb") as f:
        f.write(_wav_bytes(samples, bits, extensible))
    info, pcm = wav.read_wav(path)
    jinfo, jpcm = jax_wav.read_wav(path)
    assert dataclasses.astuple(info) == dataclasses.astuple(jinfo) and info.duration == jinfo.duration
    assert pcm.dtype == np.float32 and pcm.tobytes() == jpcm.tobytes()
    r, jr = streams.WavStreamReader(path), jax_streams.WavStreamReader(path)
    assert dataclasses.astuple(r.info) == dataclasses.astuple(jr.info) and r.num_frames == jr.num_frames == 4
    for start, count in ((0, 1), (1, 2), (3, 1), (2, 5), (9, 2)):        # reads past the end are zeros
        assert r.read_frames(start, count).tobytes() == jr.read_frames(start, count).tobytes()
        got, want = r.read_frames_i16(start, count), jr.read_frames_i16(start, count)
        assert (got is None) == (want is None) == (bits != 16)
        if got is not None:
            assert got.tobytes() == want.tobytes()


def test_pcm_conversions_bitwise_equal_jax():
    x = np.random.default_rng(1).standard_normal(4000).astype(np.float32)
    x[:8] = [-1.0, 1.0, -1.5, 2.0, 0.0, -0.0, 1e-30, -32767.5 / 32768]
    assert wav.float_to_int16(x).tobytes() == jax_wav.float_to_int16(x).tobytes()
    s = np.arange(-32768, 32768, 7, dtype=np.int16)
    assert wav.int16_to_float(s).tobytes() == jax_wav.int16_to_float(s).tobytes()


def test_wav_writers_byte_equal_jax_fresh_and_resumed(tmp_path):
    pcm = np.random.default_rng(2).uniform(-1.2, 1.2, (2, 3000)).astype(np.float32)
    out = {}
    for name, mod in (("port", streams), ("jax", jax_streams)):
        path = str(tmp_path / f"{name}.wav")
        w = mod.WavStreamWriter(path, channels=2)
        w.append(pcm[:, :1000])
        w.append_i16(wav.float_to_int16(pcm[:, 1000:2500]))
        w.close()
        fresh = _bytes(path)
        w = mod.WavStreamWriter(path, channels=2, resume_at_samples=1700)     # drops 800 samples
        w.append(pcm[:, 2500:])
        w.close()
        out[name] = (fresh, _bytes(path))
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) == 44 + (1700 + 500) * 4


def test_aea_header_writers_and_reader_byte_equal_jax(tmp_path):
    for title, count, nch in (("", 0, 1), ("a title", 70, 2), ("x" * 300, 2**31, 2)):
        assert aea.make_header(title, count, nch) == jax_aea.make_header(title, count, nch)
    units = np.random.default_rng(3).integers(0, 256, (7, 212)).astype(np.uint8)
    out = {}
    for name, mod, amod in (("port", streams, aea), ("jax", jax_streams, jax_aea)):
        whole = str(tmp_path / f"{name}_whole.aea")
        amod.write_aea(whole, units, title="w", channel_count=1)
        path = str(tmp_path / f"{name}.aea")
        w = mod.AeaStreamWriter(path, title="s", channel_count=2)
        w.append(units[:5])
        w.close()
        w = mod.AeaStreamWriter(path, title="s", channel_count=2, resume_at_frame=3)
        w.append(units[5:])
        assert w.frames_written == 5
        w.close()
        with open(path, "ab") as f:
            f.write(b"\x01" * 100)                                   # a partial trailing unit
        r = mod.AeaStreamReader(path)
        out[name] = (_bytes(whole), _bytes(path), r.num_units, r.meta.frame_count, r.read_units(2, 9).tobytes())
    assert out["port"] == out["jax"]
    assert out["port"][2:4] == (5, 5)


def test_stream_readers_map_nothing_of_the_file(tmp_path):
    """The port's readers read each request at its offset: after a whole
    file in chunks, no page of it is mapped (a mapping keeps every page read
    in the resident set: an hour-long WAV grew `encode_file`'s RSS by its
    size, harness/stream_stress.py), and the chunks equal the JAX package's
    memmapped readers' on a copy of the same bytes."""
    pcm = _stereo_i16(1.0)
    units = np.random.default_rng(5).integers(0, 256, (173, 212)).astype(np.uint8)
    paths = {}
    for name in ("port", "jax"):
        paths[name] = (str(tmp_path / f"{name}.wav"), str(tmp_path / f"{name}.aea"))
        wav.write_wav(paths[name][0], pcm)
        aea.write_aea(paths[name][1], units, title="t", channel_count=1)
    readers = {name: (mod.WavStreamReader(paths[name][0]), mod.AeaStreamReader(paths[name][1]))
               for name, mod in (("port", streams), ("jax", jax_streams))}
    (got, got_aea), (want, want_aea) = readers["port"], readers["jax"]
    for start in range(0, got.num_frames + 2, 16):                   # past the end too
        assert np.array_equal(got.read_frames_i16(start, 16), want.read_frames_i16(start, 16))
        assert np.array_equal(got.read_frames(start, 16), want.read_frames(start, 16))
    for start in range(0, got_aea.num_units + 40, 40):
        assert np.array_equal(got_aea.read_units(start, 40), want_aea.read_units(start, 40))
    # the reused buffer: a large read, then smaller and overlapping ones
    for start, count in ((0, got.num_frames + 3), (5, 1), (2, 7), (got.num_frames - 1, 4), (0, 0)):
        assert np.array_equal(got.read_frames_i16(start, count), want.read_frames_i16(start, count))
    for start, count in ((0, 173), (170, 9), (3, 1), (17, 50), (200, 5)):
        assert np.array_equal(got_aea.read_units(start, count), want_aea.read_units(start, count))
    with open("/proc/self/maps") as f:
        maps = f.read()
    got.close()
    got_aea.close()
    assert paths["jax"][0] in maps                                    # the yardstick does map its file
    assert paths["port"][0] not in maps and paths["port"][1] not in maps


def test_checkpoint_loads_in_either_package(tmp_path):
    state = [{"tail0": np.arange(16, dtype=np.float32), "synth_low_delay": np.ones(46, np.float32)},
             {"tail0": -np.arange(16, dtype=np.float32), "synth_low_delay": np.zeros(46, np.float32)}]
    for saver, loader in ((streams, jax_streams), (jax_streams, streams)):
        path = str(tmp_path / "c.npz")
        saver.StreamCheckpoint(path).save(123, state, {"input": "/x", "chunk_frames": 16})
        off, got, meta = loader.StreamCheckpoint(path).load()
        assert off == 123 and meta == {"frame_offset": 123, "channels": 2, "input": "/x", "chunk_frames": 16}
        for g, w in zip(got, state):
            assert sorted(g) == sorted(w) and all(g[k].tobytes() == w[k].tobytes() for k in w)
        loader.StreamCheckpoint(path).remove()
        assert not os.path.exists(path) and saver.StreamCheckpoint(path).load() is None


# ---------------------------------------------------------------------------
# file transcodes
# ---------------------------------------------------------------------------
def _odd_stereo(files) -> str:
    """The stereo AEA without its last unit (header count patched)."""
    path = str(files["dir"] / "odd.aea")
    meta, units = aea.read_aea(files["port.aea"])
    aea.write_aea(path, units[:-1], title="odd", channel_count=2)
    return path


@pytest.mark.parametrize("which", ["golden", "stereo_odd"])
def test_decode_file_byte_equal_jax_exact(files, which, tmp_path):
    src = GOLDEN if which == "golden" else _odd_stereo(files)
    got, want = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    tm = {}
    res = port.decode_file(src, got, chunk_frames=CHUNK, device="cpu", timings=tm)
    jres = jax_processor.decode_file(src, want, engine="exact", chunk_frames=CHUNK)
    assert _bytes(got) == _bytes(want)
    assert dataclasses.astuple(res) == dataclasses.astuple(jres)
    assert set(tm) == {"read_s", "dispatch_s", "drain_fetch_s", "write_s", "n_drains", "drain_bytes"}
    assert tm["n_drains"] == -(-res.samples // 512 // CHUNK) and tm["drain_bytes"] == res.samples * res.channels * 2


def test_encode_file_byte_equal_encode_pcm_and_jax_header(files, tmp_path):
    units = port.encode_pcm(files["i16"], chunk_frames=CHUNK, device="cpu")
    meta, got = aea.read_aea(files["port.aea"])
    assert got.shape == (2 * 35, 212) and np.array_equal(got, units)
    assert (meta.frame_count, meta.channel_count, meta.title) == (70, 2, "t")
    assert _bytes(files["port.aea"])[:2048] == _bytes(files["jax.aea"])[:2048]
    res = files["result"]
    assert (res.frames, res.channels, res.samples) == (70, 2, files["i16"].shape[1])
    tm = files["timings"]
    assert (tm["n_drains"], tm["drain_bytes"]) == (3, 70 * 212)
    # the port's AEA decodes to the same WAV through the JAX package's exact engine
    want = str(tmp_path / "jax.wav")
    jax_processor.decode_file(files["port.aea"], want, engine="exact", chunk_frames=CHUNK)
    assert _bytes(files["port.wav"]) == _bytes(want)


@pytest.mark.parametrize("bits,channels,seconds", [(24, 1, 0.03), (16, 1, 0.0)])
def test_encode_file_short_and_wide_inputs(tmp_path, bits, channels, seconds):
    """A 24-bit file shorter than one chunk goes up as f32; an empty data
    chunk still gives one (silent) frame, like the JAX package's reader."""
    n = int(44100 * seconds)
    samples = np.random.default_rng(4).integers(-(1 << 20), 1 << 20, (channels, n), dtype=np.int64)
    path, out = str(tmp_path / "in.wav"), str(tmp_path / "out.aea")
    with open(path, "wb") as f:
        f.write(_wav_bytes(samples, bits))
    res = port.encode_file(path, out, chunk_frames=CHUNK, device="cpu")
    _, pcm = wav.read_wav(path)
    meta, got = aea.read_aea(out)
    assert meta.frame_count == res.frames == max(1, -(-n // 512)) == jax_streams.WavStreamReader(path).num_frames
    assert np.array_equal(got, port.encode_pcm(pcm, chunk_frames=CHUNK, device="cpu"))


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_kill_and_resume_byte_identical(files, tmp_path, mode):
    src, ref, run = ((files["in.wav"], files["port.aea"], port.encode_file) if mode == "encode"
                     else (files["port.aea"], files["port.wav"], port.decode_file))
    kwargs = dict(chunk_frames=CHUNK, device="cpu", checkpoint=str(tmp_path / "ck.npz"), checkpoint_every=1)
    if mode == "encode":
        kwargs["title"] = "t"
    out = str(tmp_path / f"resumed.{mode}")
    with pytest.raises(KeyboardInterrupt):
        run(src, out, on_progress=_KillAt(2), **kwargs)             # killed after the second of three chunks
    offset, states, meta = streams.StreamCheckpoint(kwargs["checkpoint"]).load()
    assert offset == 2 * CHUNK and len(states) == 2 and meta["input"] == os.path.abspath(src)
    run(src, out, **kwargs)
    assert not os.path.exists(kwargs["checkpoint"])
    assert _bytes(out) == _bytes(ref)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_decode_resumes_across_packages(files, tmp_path, first):
    runs = {"jax": lambda **kw: jax_processor.decode_file(engine="exact", **kw),
            "port": lambda **kw: port.decode_file(device="cpu", **kw)}
    second = "port" if first == "jax" else "jax"
    kw = dict(input_aea=files["port.aea"], output_wav=str(tmp_path / "out.wav"), chunk_frames=CHUNK,
              checkpoint=str(tmp_path / "ck.npz"), checkpoint_every=1)
    with pytest.raises(KeyboardInterrupt):
        runs[first](on_progress=_KillAt(2), **kw)
    runs[second](**kw)
    assert _bytes(kw["output_wav"]) == _bytes(files["port.wav"])


def test_encode_clips_within_one_percent_of_solo():
    """The JAX package's tolerance (tests/test_streaming_corpus.py): ragged
    clips, mono and stereo mixed, in one batch against each alone."""
    rng = np.random.default_rng(5)
    t = np.arange(512 * 4) / 44100
    clips = [
        (0.5 * np.sin(2 * np.pi * 300 * t[: 512 * 2])).astype(np.float32),
        np.stack([0.4 * np.sin(2 * np.pi * 440 * t[:1500]), rng.standard_normal(1500) * 0.2]).astype(np.float32),
        (rng.standard_normal((1, 700)) * 0.3).astype(np.float32),
        (0.3 * np.sin(2 * np.pi * 900 * t)).astype(np.float32),
        np.zeros((2, 10), np.float32),
    ]
    seen = []
    batched = port.encode_clips(clips, device="cpu", on_progress=lambda i, n: seen.append((i, n)))
    assert seen == [(i + 1, 5) for i in range(5)]
    for clip, units in zip(clips, batched):
        solo = port.encode_pcm(np.atleast_2d(clip), device="cpu")
        assert units.shape == solo.shape
        assert (units != solo).mean() < 0.01
    with pytest.raises(ValueError):
        port.encode_clips([np.zeros((3, 10), np.float32)], device="cpu")


# ---------------------------------------------------------------------------
# profiling hooks
# ---------------------------------------------------------------------------
def test_nan_debugging_names_the_stage():
    frames = torch.zeros(1, 2, 512)
    frames[0, 1, 7] = float("nan")
    _encode_batch_dev(frames, port.EncoderOptions(), None)          # off: no check
    profiling.enable_nan_debugging()
    try:
        _encode_batch_dev(torch.zeros(1, 2, 512), port.EncoderOptions(), None)
        with pytest.raises(FloatingPointError, match="encoder input PCM"):
            _encode_batch_dev(frames, port.EncoderOptions(), None)
        with pytest.raises(FloatingPointError, match="encoder analysis spectra"):
            port.encode_step(frames[0], port.encoder_init_state("cpu"), (1.0,) * 3, 1.0)
        with pytest.raises(FloatingPointError, match="decoder PCM"):
            profiling.nan_check("decoder PCM", frames)
    finally:
        profiling.enable_nan_debugging(False)
    profiling.nan_check("decoder PCM", frames)


def test_stream_stats_equal_jax():
    _, units = aea.read_aea(GOLDEN)
    fd = unpack_frames(torch.from_numpy(units.copy()))
    assert profiling.stream_stats(fd) == jax_stream_stats(jax_unpack(units))
    empty = unpack_frames(torch.zeros((0, 212), dtype=torch.uint8))
    assert profiling.stream_stats(empty) == jax_stream_stats(JaxFrameData.zeros(0))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _overrunning_aea(path):
    """tests/test_processor_cli.py: 3 silent units, 1 overrunning unit, a
    header that declares 5 and a partial fifth."""
    units = np.zeros((4, 212), np.uint8)
    units[:3, 0] = 0xAC
    units[3, 1] = 0xFF
    units[3, 2:28] = 0xFF
    aea.write_aea(path, units, channel_count=1)
    raw = bytearray(_bytes(path))
    raw[260:264] = (5).to_bytes(4, "little")
    with open(path, "wb") as f:
        f.write(bytes(raw) + b"\x01" * 100)
    return path


@pytest.mark.parametrize("which", ["golden", "errors"])
def test_cli_json_equals_jax_dump(tmp_path, which):
    src = GOLDEN if which == "golden" else _overrunning_aea(str(tmp_path / "x.aea"))
    got, want = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert cli.main(["--json", src, got, "--quiet", "--device", "cpu"]) == 0
    assert jax_cli.main(["--json", src, want, "--quiet"]) == 0
    assert json.load(open(got)) == json.load(open(want))
    if which == "errors":
        assert json.load(open(got))["summary"]["errorFrames"] == 2


def test_cli_errors_equal_jax(tmp_path, capsys):
    wav_in, out = str(tmp_path / "in.wav"), str(tmp_path / "out.aea")
    wav.write_wav(wav_in, np.zeros((1, 1024), np.int16))
    with open(out, "w") as f:
        f.write("x")
    for argv in (["a", "b"], ["--encode", "--decode", "a", "b"], ["--encode", wav_in, out, "--quiet"],
                 ["--encode", wav_in, out, "--force", "--quiet", "--title", "café"],
                 ["--decode", str(tmp_path / "missing.aea"), str(tmp_path / "o.wav"), "--quiet"]):
        got = cli.main(argv + ["--device", "cpu"]), capsys.readouterr()
        want = jax_cli.main(argv + ["--engine", "exact"]), capsys.readouterr()
        assert got == want, argv
        assert got[0] == 1
    for title in ("ok title", "café", "x" * 256):
        try:
            jax_cli.validate_title(title)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                cli.validate_title(title)
        else:
            cli.validate_title(title)


def test_cli_on_the_cpu_never_touches_cuda(files, tmp_path, monkeypatch, capsys):
    """--encode, --decode and --json with --device cpu, with every CUDA entry
    point made to fail; the files equal encode_file's and decode_file's."""
    def no_cuda(*args, **kwargs):
        raise AssertionError("CUDA touched")

    for name in ("is_available", "init", "synchronize", "current_stream", "Stream", "Event", "device_count"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    aea_out, wav_out = str(tmp_path / "o.aea"), str(tmp_path / "o.wav")
    assert cli.main(["--encode", files["in.wav"], aea_out, "--title", "t", "--chunk-frames", str(CHUNK),
                     "--device", "cpu"]) == 0
    assert cli.main(["--decode", files["port.aea"], wav_out, "--quiet", "--chunk-frames", "7", "--device", "cpu"]) == 0
    assert cli.main(["--json", files["port.aea"], str(tmp_path / "d.json"), "--quiet", "--device", "cpu"]) == 0
    assert "(AEA 292kbps)" in capsys.readouterr().out
    assert _bytes(aea_out) == _bytes(files["port.aea"]) and _bytes(wav_out) == _bytes(files["port.wav"])


def test_cli_profile_leaves_a_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    assert cli.main(["--json", GOLDEN, str(tmp_path / "d.json"), "--quiet", "--device", "cpu",
                     "--profile", str(trace_dir)]) == 0
    events = json.load(open(trace_dir / profiling.TRACE_FILE))["traceEvents"]
    assert any("read_fields" in str(e.get("name", "")) or "aten::" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize(
    "call",
    [
        lambda d: port.encode_file(os.path.join(d, "in.wav"), os.path.join(d, "x.aea")),
        lambda d: port.decode_file(GOLDEN, os.path.join(d, "x.wav")),
        lambda d: port.encode_clips([np.zeros(512, np.float32)]),
        lambda d: cli.dump_json(GOLDEN, os.path.join(d, "x.json"), True),
    ],
)
def test_file_entry_points_default_to_the_card(files, call):
    if torch.cuda.is_available():
        call(str(files["dir"]))
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call(str(files["dir"]))


def test_cli_default_device_is_the_card(tmp_path, capsys):
    code = cli.main(["--json", GOLDEN, str(tmp_path / "d.json"), "--quiet"])
    if torch.cuda.is_available():
        assert code == 0
    else:
        assert code == 1 and "CUDA is not available" in capsys.readouterr().err
        assert not os.path.exists(tmp_path / "d.json")


def test_cli_runs_as_a_module(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["carta1-torch", "--help"])
    with warnings.catch_warnings(), pytest.raises(SystemExit) as done:
        warnings.simplefilter("ignore", RuntimeWarning)         # the module is imported already
        runpy.run_module("carta1_tpu_torch.cli", run_name="__main__")
    out = capsys.readouterr().out
    assert done.value.code == 0 and "--device" in out and "--engine" in out and "--platform" not in out
