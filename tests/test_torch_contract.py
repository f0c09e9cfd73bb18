"""The JAX package's calling contract, end to end on the CPU.

The same positional calls go to `carta1_tpu` and to `carta1_tpu_torch`
(the port's own `device` by keyword) and must give the same bytes: the
port takes the JAX package's positional parameters in its order, so a
call written for one binds the same parameters in the other.  With it,
`write_wav` on float input and the exact engine's scale factor of a NaN
peak.  The JAX side runs its NumPy gold engine (`engine="exact"`) and host
IO only, so nothing here compiles a JAX program.  The same calls on the
card: chip_smoke.py phase 13.
"""

import os
import struct
import warnings

import numpy as np
import pytest
import torch

from carta1_tpu import processor as jax_processor
from carta1_tpu.gold.encoder import gold_encode_frames as jax_gold_encode_frames
from carta1_tpu.io import wav as jax_wav
from carta1_tpu.parallel import corpus as jax_corpus

import carta1_tpu_torch as port
from carta1_tpu_torch import constants as C
from carta1_tpu_torch.gold.encoder import gold_encode_frames
from carta1_tpu_torch.io import aea, wav
from carta1_tpu_torch.ops.bitpack import unpack_frames
from carta1_tpu_torch.parallel.corpus import transcode_corpus
from carta1_tpu_torch.pipeline.decoder import decode_frames, decode_step_fast, decoder_init_state

NFRAMES = 5                                  # a few stereo frames, the last one short
# The JAX package's file paths pad every chunk to `chunk_frames` frames, so
# its default of 8192 would run its NumPy gold engine over some 8,000 frames
# of padding (about 20 s a call).  Its calls below name a chunk of this size
# by keyword, after the same positional arguments; the frames' bytes do not
# depend on the chunk size (the stream state is carried).
JAX_CHUNK = 8


@pytest.fixture(autouse=True, scope="module")
def _no_native_build():
    """The JAX package's host packers in NumPy: no C++ build on first use."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CARTA1_NO_NATIVE", "1")
        yield


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _stereo_f32(seed=11) -> np.ndarray:
    """Noise with a burst (short blocks) over NFRAMES frames, the last one partial."""
    rng = np.random.default_rng(seed)
    n = (NFRAMES - 1) * C.SAMPLES_PER_FRAME + 77
    x = rng.standard_normal((2, n)) * 0.2
    x[:, n // 2: n // 2 + 200] += 0.5
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A stereo WAV and the JAX package's AEA and WAV of it, both made by its
    positional calls with the exact engine."""
    d = tmp_path_factory.mktemp("contract")
    p = {k: str(d / k) for k in ("in.wav", "jax.aea", "jax.wav")}
    jax_wav.write_wav(p["in.wav"], _stereo_f32())
    jax_processor.encode_file(p["in.wav"], p["jax.aea"], None, "exact", chunk_frames=JAX_CHUNK)
    jax_processor.decode_file(p["jax.aea"], p["jax.wav"], "exact", chunk_frames=JAX_CHUNK)
    return {"dir": d, **p}


@pytest.mark.parametrize("args", [(None, "exact"), (None, "exact", "a title", 2)],
                         ids=["options-engine", "options-engine-title-chunk"])
def test_encode_file_jax_positional_call_writes_the_jax_bytes(files, args):
    """`encode_file(wav, aea, None, "exact", ...)`: the engine is the exact
    one and the header's title is the given title (or empty), as in the JAX
    package, and the file equals the keyword call's."""
    jax_out, got, kw = (os.path.join(files["dir"], f"{k}-{len(args)}.aea") for k in ("jax", "port", "kw"))
    jax_processor.encode_file(files["in.wav"], jax_out, *args, **({} if len(args) > 3 else {"chunk_frames": JAX_CHUNK}))
    port.encode_file(files["in.wav"], got, *args, device="cpu")
    names = ("options", "engine", "title", "chunk_frames")
    port.encode_file(files["in.wav"], kw, device="cpu", **dict(zip(names, args)))
    assert _bytes(got) == _bytes(jax_out) == _bytes(kw)
    meta, units = aea.read_aea(got)
    assert meta.title == (args[2] if len(args) > 2 else "") and units.shape == (2 * NFRAMES, C.SOUND_UNIT_SIZE)
    tpu = os.path.join(files["dir"], "tpu.aea")
    port.encode_file(files["in.wav"], tpu, device="cpu")
    assert aea.read_aea(tpu)[1].tobytes() != units.tobytes()      # the call did not fall back to the tpu engine


@pytest.mark.parametrize("args", [("exact",), ("exact", 2)], ids=["engine", "engine-chunk"])
def test_decode_file_jax_positional_call_writes_the_jax_bytes(files, args):
    got, kw = (os.path.join(files["dir"], f"{k}-{len(args)}.wav") for k in ("port", "kw"))
    port.decode_file(files["jax.aea"], got, *args, device="cpu")
    port.decode_file(files["jax.aea"], kw, device="cpu", **dict(zip(("engine", "chunk_frames"), args)))
    assert _bytes(got) == _bytes(files["jax.wav"]) == _bytes(kw)


@pytest.mark.parametrize("chunk", [None, 2], ids=["one-chunk", "chunks-of-2"])
def test_encode_pcm_and_decode_units_jax_positional_calls_agree_with_jax(chunk):
    pcm = _stereo_f32(seed=12)
    extra = () if chunk is None else (chunk,)
    want = jax_processor.encode_pcm(pcm, None, "exact", *extra)
    units = port.encode_pcm(pcm, None, "exact", *extra, device="cpu")
    assert units.tobytes() == want.tobytes()
    assert units.tobytes() == port.encode_pcm(pcm, engine="exact", device="cpu").tobytes()
    want_pcm = jax_processor.decode_units(want, 2, "exact", *extra)
    got_pcm = port.decode_units(units, 2, "exact", *extra, device="cpu")
    assert got_pcm.dtype == torch.float32 and got_pcm.numpy().tobytes() == np.asarray(want_pcm, np.float32).tobytes()


def test_the_ports_old_positional_order_raises():
    """A call in the port's order before the JAX one (`device` third) names
    no engine and raises, where it used to bind."""
    pcm = _stereo_f32()[:, :C.SAMPLES_PER_FRAME]
    with pytest.raises(ValueError, match="Unknown engine"):
        port.encode_pcm(pcm, None, "cpu")
    with pytest.raises(ValueError, match="Unknown engine"):
        port.decode_units(np.zeros((2, C.SOUND_UNIT_SIZE), np.uint8), 2, "cpu")


def test_decode_frames_positional_fast_runs_the_fast_decoder(files):
    units = torch.from_numpy(aea.read_aea(files["jax.aea"])[1][0::2].copy())
    fd = unpack_frames(units)
    got, state = decode_frames(fd, None, True, device="cpu")
    want, want_state = decode_step_fast(fd, decoder_init_state(torch.device("cpu")))
    kw, _ = decode_frames(fd, fast=True, device="cpu")
    exact, _ = decode_frames(fd, None, False, device="cpu")
    assert torch.equal(got, want) and torch.equal(got, kw)
    assert all(torch.equal(state[k], want_state[k]) for k in want_state)
    assert not torch.equal(got, exact)                             # the fast decoder's f32 transforms


def test_transcode_corpus_jax_positional_call_agrees_with_jax(files, tmp_path):
    """`transcode_corpus(jobs, "decode", None, "exact", chunk_frames)` in both
    packages: the same WAV bytes."""
    got, want = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    r = transcode_corpus([(files["jax.aea"], got)], "decode", None, "exact", 2, device="cpu")
    jr = jax_corpus.transcode_corpus([(files["jax.aea"], want)], "decode", None, "exact", 2)
    assert not r.failed and not jr.failed and r.frames == jr.frames
    assert _bytes(got) == _bytes(want) == _bytes(files["jax.wav"])


# ---------------------------------------------------------------------------
# write_wav on float input
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 700), (700,)], ids=["stereo", "mono"])
def test_write_wav_on_f32_writes_the_jax_bytes(tmp_path, shape):
    """Values past +-1, exactly +-1 and 0: the port's `write_wav` converts
    with the reference's scale and truncation, as the JAX package's does."""
    pcm = np.random.default_rng(3).uniform(-1.5, 1.5, shape).astype(np.float32)
    pcm.reshape(-1)[:6] = [1.0, -1.0, 0.0, -0.0, 1.0 + 2 ** -23, -1.0 - 2 ** -23]
    jax_wav.write_wav(str(tmp_path / "want.wav"), pcm)
    wav.write_wav(str(tmp_path / "got.wav"), pcm)
    assert _bytes(tmp_path / "got.wav") == _bytes(tmp_path / "want.wav")


def test_write_wav_writes_int16_as_it_is(tmp_path):
    i16 = np.random.default_rng(4).integers(-32768, 32768, (2, 300)).astype(np.int16)
    i16[:, :2] = [[-32768, 32767], [0, -1]]
    wav.write_wav(str(tmp_path / "got.wav"), i16)
    data = i16.T.astype("<i2").tobytes()
    header = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
              + struct.pack("<IHHIIHH", 16, 1, 2, 44100, 44100 * 4, 4, 16) + b"data" + struct.pack("<I", len(data)))
    assert _bytes(tmp_path / "got.wav") == header + data


# ---------------------------------------------------------------------------
# the exact engine's scale factor of a NaN peak
# ---------------------------------------------------------------------------
def test_exact_engine_scale_factors_on_a_nan_frame_equal_golds():
    """One NaN sample in a mono stream: gold gives its BFUs scale factor 63
    (`carta1_tpu.gold.coding.find_scale_factors` clips a NaN ceil to 63);
    the exact engine's
    scale factors equal gold's on every frame.  Its units past the scale
    factors are not compared: gold casts NaN to int64 in `quantize_js`,
    which NumPy leaves undefined."""
    pcm = np.random.default_rng(5).uniform(-0.5, 0.5, (4, C.SAMPLES_PER_FRAME)).astype(np.float32)
    pcm[1, 100] = np.nan
    fd, _ = gold_encode_frames(pcm, device="cpu")
    with warnings.catch_warnings(), np.errstate(invalid="ignore"):
        warnings.simplefilter("ignore", RuntimeWarning)            # gold's NaN cast in quantize_js
        want = np.asarray(jax_gold_encode_frames(pcm)[0].scale_factors)
    assert (want == 63).any() and (want[0] != 63).all()
    np.testing.assert_array_equal(fd.scale_factors.numpy(), want)
