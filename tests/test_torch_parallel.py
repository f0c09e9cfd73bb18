"""The port's frame sharding, sharded file paths, corpus transcoder and
multi-process launcher, on the CPU.

Meshes are tuples of CPU devices (`make_mesh(("cpu",) * k)`): the shards
run as rows of one batch, with the same halo rebuild a mesh of cards
runs.  `("cpu", "cpu:0", "cpu")` names two devices (a mesh groups its
shards by `torch.device`, and `cpu` is not `cpu:0`), so it runs the path
of a mesh over several cards: shards 0 and 2 in one group, shard 1 in
another, gathered on the first device.  References: the gold engine and the port's unsharded paths for the
frames; the JAX package's host code (its corpus transcoder with
`engine="exact"`, its checkpoint) for the corpus, so nothing here
compiles a JAX program.  The same paths on the card:
tests/test_torch_kernels_cuda.py and chip_smoke.py phase 10.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from carta1_tpu.gold import gold_decode_frames, gold_encode_frames
from carta1_tpu.io import wav as jax_wav
from carta1_tpu.parallel.corpus import Checkpoint as JaxCheckpoint
from carta1_tpu.parallel.corpus import transcode_corpus as jax_transcode_corpus

from carta1_tpu_torch import EncoderOptions, FrameData, decode_file, decode_frames, encode_file, encode_frames
from carta1_tpu_torch import constants as C
from carta1_tpu_torch import encoder_init_state, testing
from carta1_tpu_torch.parallel import corpus, decode_frames_sharded, encode_frames_sharded, make_mesh, multihost
from carta1_tpu_torch.pipeline.encoder import analysis_step
from carta1_tpu_torch.pipeline.streaming import chunk_frames_array, encode_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CHUNK = 16


@pytest.fixture(autouse=True, scope="module")
def _no_native_build():
    """The JAX package's host packers in NumPy: no C++ build on first use."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CARTA1_NO_NATIVE", "1")
        yield


def _signal(nframes: int, channels: int = 1, seed: int = 5) -> np.ndarray:
    """f32 [channels, F, 512]: noise, a tone and a burst (short blocks)."""
    rng = np.random.default_rng(seed)
    t = np.arange(nframes * 512) / 44100
    x = 0.3 * rng.standard_normal((channels, nframes * 512)) + 0.4 * np.sin(2 * np.pi * 700 * t)
    x[:, nframes * 200: nframes * 200 + 300] += 0.6
    return x.astype(np.float32).reshape(channels, nframes, 512)


def _stacked(fds) -> FrameData:
    """NumPy FrameData per channel -> one torch FrameData [C, F, ...] on the CPU."""
    return FrameData(*(torch.from_numpy(np.stack([np.asarray(getattr(fd, k), np.int32) for fd in fds]))
                       for k in FrameData.fields()))


def _fields(fd: FrameData) -> dict:
    return {k: getattr(fd, k).cpu().numpy() for k in FrameData.fields()}


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(((a.view(np.int32) == b.view(np.int32)) | ((a == 0) & (b == 0))).all())


def _envelope(a: dict, b: dict) -> int:
    """The JAX package's sharded-encode envelope (tests/test_sharding.py):
    block modes and scale factors equal, quantized values at most 1 apart in
    fewer than 1e-3 of them.  Returns the count of differing fields."""
    assert np.array_equal(a["block_modes"], b["block_modes"])
    assert np.array_equal(a["scale_factors"], b["scale_factors"])
    qdiff = np.abs(a["quantized"].astype(np.int64) - b["quantized"])
    assert qdiff.max() <= 1 and (qdiff != 0).mean() < 1e-3
    return sum(int((a[k] != b[k]).sum()) for k in a)


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


class _KillAt:
    """Progress callback that raises on its n-th call (a killed run)."""

    def __init__(self, after):
        self.after, self.calls = after, 0

    def __call__(self, done, total):
        self.calls += 1
        if self.calls >= self.after:
            raise KeyboardInterrupt("simulated kill")


# ---------------------------------------------------------------------------
# Frame sharding
# ---------------------------------------------------------------------------
def test_make_mesh():
    mesh = make_mesh(("cpu",) * 3)
    assert mesh == (CPU,) * 3 and all(isinstance(d, torch.device) for d in mesh)
    assert make_mesh(mesh) == mesh
    with pytest.raises(ValueError):
        make_mesh(())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(("cuda:0", "cuda:0"))


@pytest.fixture(scope="module")
def gold_stereo():
    """21 stereo frames, the gold engine's FrameData per channel and its PCM."""
    pcm = _signal(21, 2, seed=9)
    fds = [gold_encode_frames(pcm[ch])[0] for ch in range(2)]
    return pcm, fds, [gold_decode_frames(fd)[0] for fd in fds]


# one device repeated (one group: the shards are rows of one batch), and two
# devices with shards 0 and 2 on the first (the gather across groups)
MESHES = pytest.mark.parametrize("devices", [("cpu",), ("cpu",) * 2, ("cpu",) * 3, ("cpu", "cpu:0", "cpu")],
                                 ids=["1", "2", "3", "two_groups"])


@MESHES
def test_sharded_decode_bitwise_gold_and_unsharded(gold_stereo, devices):
    """21 frames (ragged on 2 shards): mono alone, and stereo with the state
    carried across two chunks of 13 and 8 frames."""
    _, fds, want = gold_stereo
    mesh = make_mesh(devices)
    got, st = decode_frames_sharded(fds[0], mesh)
    un, un_st = decode_frames(_stacked(fds[:1])[0], device=CPU)
    assert _bits_equal(got.numpy(), want[0]) and _bits_equal(got.numpy(), un.numpy())
    assert all(_bits_equal(st[k].numpy(), un_st[k].numpy()) for k in un_st)

    stereo = _stacked(fds)
    a, st = decode_frames_sharded(stereo[:, :13], mesh)
    b, st = decode_frames_sharded(stereo[:, 13:], mesh, st)
    got = torch.cat([a, b], dim=1).numpy()
    assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])
    _, un_st = decode_frames(stereo, device=CPU)
    assert all(_bits_equal(st[k].numpy(), un_st[k].numpy()) for k in un_st)


@MESHES
def test_sharded_encode_inside_the_jax_envelope(gold_stereo, devices):
    """Stereo, 21 frames in chunks of 13 and 8 with the state carried,
    against the unsharded encode of the whole; the state after the stream
    too.  The envelope is the floor; equality is expected (the rows are the
    unsharded batch's) but not promised for an f32 encoder.  Against the
    gold engine, as tests/test_torch_encode.py holds the unsharded encode:
    block modes equal, scale factors equal but for one-off indices where
    the peak rounds across a table value, and, where the word lengths are
    gold's (the default allocator is not gold's), quantized values in the
    envelope."""
    pcm, gold_fds, _ = gold_stereo
    mesh = make_mesh(devices)
    a, st = encode_frames_sharded(pcm[:, :13], mesh=mesh)
    b, st = encode_frames_sharded(torch.from_numpy(pcm[:, 13:]), mesh=mesh, state=st)
    got = {k: np.concatenate([x, y], axis=1) for (k, x), y in zip(_fields(a).items(), _fields(b).values())}
    want_fd, want_st = encode_frames(pcm, device=CPU)
    _envelope(got, _fields(want_fd))
    assert all(np.abs(st[k].numpy() - want_st[k].numpy()).max() <= 1e-6 for k in want_st)

    bfu, _, _, _ = analysis_step(torch.from_numpy(pcm), encoder_init_state(CPU, 2), (1.0,) * 3)
    peaks = torch.where(torch.from_numpy(C.BFU_SLOT_MASK), bfu.abs(), 0.0).amax(dim=-1).numpy()
    for ch, gold in enumerate(gold_fds):
        assert np.array_equal(got["block_modes"][ch], gold.block_modes)
        assert testing.scale_factor_faults(got["scale_factors"][ch], gold.scale_factors, peaks[ch]) == 0
        same = got["word_lengths"][ch] == gold.word_lengths
        qdiff = np.abs(got["quantized"][ch][same].astype(np.int64) - gold.quantized[same])
        assert same.any() and qdiff.max() <= 1 and (qdiff != 0).mean() < 1e-3


def test_backend_agreement_flags_what_rounding_cannot_explain(gold_stereo):
    """The check the card tests and chip_smoke.py hold a card-and-CPU mesh's
    encode to: equal encodes pass; a changed block mode, a scale factor two
    indices off, or word lengths unequal in more than 1% of BFUs fail."""
    pcm = gold_stereo[0][0]
    fd, _ = encode_frames(pcm, device=CPU)
    bfu, _, _, _ = analysis_step(torch.from_numpy(pcm), encoder_init_state(CPU), (1.0,) * 3)
    peaks = torch.where(torch.from_numpy(C.BFU_SLOT_MASK), bfu.abs(), 0.0).amax(dim=-1).numpy()
    want = _fields(fd)
    assert testing.backend_agreement(want, want, peaks) == {
        "scale_factor_faults": 0, "scale_factors_differing": 0, "word_lengths_equal": 1.0, "quantized_equal": 1.0}
    for key, change in (("block_modes", lambda a: a.__setitem__((3, 0), 1 - a[3, 0])),
                        ("scale_factors", lambda a: a.__setitem__((5, 7), a[5, 7] + 2)),
                        ("word_lengths", lambda a: a.__setitem__((slice(0, 1), slice(None)), a[:1] + 1))):
        got = {k: v.copy() for k, v in want.items()}
        change(got[key])
        with pytest.raises(AssertionError):
            testing.backend_agreement(got, want, peaks)


def test_sharded_encode_takes_raw_int16_and_one_frame():
    pcm = _signal(5, 1, seed=4)[0]
    i16 = (pcm * 32767).astype(np.int16)
    mesh = make_mesh(("cpu",) * 2)
    got, _ = encode_frames_sharded(i16, mesh=mesh)
    want, _ = encode_frames(i16.astype(np.float32) / 32768.0, device=CPU)
    assert _envelope(_fields(got), _fields(want)) == 0
    # one frame on two shards: the state after it comes from the caller's state
    _, st0 = encode_frames(pcm[:3], device=CPU)
    one, st = encode_frames_sharded(pcm[3:4], mesh=mesh, state=st0)
    want, want_st = encode_frames(pcm[3:4], state=st0, device=CPU)
    assert _envelope(_fields(one), _fields(want)) == 0
    assert all(np.array_equal(st[k].numpy(), want_st[k].numpy()) for k in want_st)
    empty, _ = encode_frames_sharded(pcm[:0], mesh=mesh)
    assert empty.num_frames == 0


def test_allocator_reaches_every_encode_path():
    """allocator="reference" gives the same word lengths on the batched,
    sharded and stream paths, and other ones than the default somewhere
    (tests/test_sharding.py::test_allocator_reaches_every_encode_path)."""
    pcm = _signal(24, 1, seed=11)[0]
    ref = EncoderOptions(allocator="reference")
    wl = encode_frames(pcm, ref, device=CPU)[0].word_lengths.numpy()
    assert not np.array_equal(wl, encode_frames(pcm, device=CPU)[0].word_lengths.numpy())
    sharded, _ = encode_frames_sharded(pcm, ref, make_mesh(("cpu",) * 3))
    assert np.array_equal(sharded.word_lengths.numpy(), wl)
    chunks, n = chunk_frames_array(pcm, 8)
    streamed, _ = encode_stream(chunks, ref, device=CPU)
    assert np.array_equal(streamed.word_lengths.reshape(-1, 52)[:n].numpy(), wl)


# ---------------------------------------------------------------------------
# Sharded file paths
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stereo_wav(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_files")
    pcm = _signal(30, 2, seed=3).reshape(2, -1)[:, :-77]            # 29.85 frames: a ragged tail
    path = str(d / "in.wav")
    jax_wav.write_wav(path, pcm)
    return d, path


def test_files_with_a_mesh_equal_without(stereo_wav):
    d, wav_in = stereo_wav
    mesh = ("cpu",) * 3
    encode_file(wav_in, str(d / "plain.aea"), chunk_frames=CHUNK, device="cpu")
    encode_file(wav_in, str(d / "mesh.aea"), chunk_frames=CHUNK, mesh=mesh)
    assert _bytes(d / "mesh.aea") == _bytes(d / "plain.aea")
    decode_file(str(d / "plain.aea"), str(d / "plain.wav"), chunk_frames=CHUNK, device="cpu")
    decode_file(str(d / "plain.aea"), str(d / "mesh.wav"), chunk_frames=CHUNK, mesh=mesh)
    assert _bytes(d / "mesh.wav") == _bytes(d / "plain.wav")
    with pytest.raises(ValueError, match="mesh"):
        encode_file(wav_in, str(d / "x.aea"), mesh=mesh, device="cpu")


@pytest.mark.parametrize("killed, resumed", [("mesh", "mesh"), ("mesh", None), (None, "mesh")])
def test_killed_runs_resume_across_mesh_and_no_mesh(stereo_wav, killed, resumed):
    """The checkpoint of a mesh run has the keys of any other, so a killed
    run resumes to identical bytes with a mesh or without one."""
    d, wav_in = stereo_wav
    ref_aea, ref_wav = d / "ref.aea", d / "ref.wav"
    if not ref_aea.exists():
        encode_file(wav_in, str(ref_aea), chunk_frames=CHUNK, device="cpu")
        decode_file(str(ref_aea), str(ref_wav), chunk_frames=CHUNK, device="cpu")
    place = {None: {"device": "cpu"}, "mesh": {"mesh": ("cpu",) * 2}}
    tag = f"{killed}_{resumed}"
    for run, src, out, ref in ((encode_file, wav_in, d / f"{tag}.aea", ref_aea),
                               (decode_file, str(ref_aea), d / f"{tag}.wav", ref_wav)):
        ck = str(d / f"{tag}.npz")
        kw = dict(chunk_frames=CHUNK, checkpoint=ck, checkpoint_every=1)
        with pytest.raises(KeyboardInterrupt):
            run(src, str(out), on_progress=_KillAt(1), **kw, **place[killed])
        assert os.path.exists(ck)
        run(src, str(out), **kw, **place[resumed])
        assert not os.path.exists(ck)
        assert _bytes(out) == _bytes(ref)


# ---------------------------------------------------------------------------
# Corpus transcoder
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """Three WAVs (mono and stereo, ragged lengths) and a file that is no WAV."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    wavs = []
    for i in range(3):
        x = (0.3 * rng.standard_normal((1 + i % 2, 512 * 9 + 37 * i)) + 0.2).astype(np.float32)
        path = str(d / f"in{i}.wav")
        jax_wav.write_wav(path, x)
        wavs.append(path)
    broken = d / "broken.wav"
    broken.write_bytes(b"this is no RIFF file")
    return d, wavs, str(broken)


def test_corpus_encode_decode_equal_files_alone_and_jax_exact_decode(corpus_dir, tmp_path):
    d, wavs, _ = corpus_dir
    jobs = [(w, str(tmp_path / f"e{i}.aea")) for i, w in enumerate(wavs)]
    done = []
    res = corpus.transcode_corpus(jobs, chunk_frames=CHUNK, device="cpu", on_file_done=lambda p, n: done.append(p))
    assert res.completed == wavs == done and not res.failed and res.realtime_multiple > 0
    for w, out in jobs:
        encode_file(w, str(tmp_path / "alone.aea"), title=os.path.splitext(os.path.basename(out))[0],
                    chunk_frames=CHUNK, device="cpu")
        assert _bytes(out) == _bytes(tmp_path / "alone.aea")
    djobs = [(out, str(tmp_path / f"d{i}.wav")) for i, (_, out) in enumerate(jobs)]
    res = corpus.transcode_corpus(djobs, mode="decode", chunk_frames=4, device="cpu")
    assert len(res.completed) == 3 and not res.failed
    jax_jobs = [(src, out + ".jax.wav") for src, out in djobs]
    jres = jax_transcode_corpus(jax_jobs, mode="decode", engine="exact", chunk_frames=4,
                                process_index=0, process_count=1)
    assert len(jres.completed) == 3 and res.frames == jres.frames
    for (_, out), (_, jout) in zip(djobs, jax_jobs):
        assert _bytes(out) == _bytes(jout)


def test_corpus_failure_removes_output_and_checkpoint_resumes(corpus_dir, tmp_path):
    d, wavs, broken = corpus_dir
    jobs = [(w, str(tmp_path / f"o{i}.aea")) for i, w in enumerate(wavs)] + [(broken, str(tmp_path / "broken.aea"))]
    ck = str(tmp_path / "ckpt.json")
    res = corpus.transcode_corpus(jobs, chunk_frames=8, checkpoint_path=ck, device="cpu", max_retries=1)
    assert res.completed == wavs and list(res.failed) == [broken]
    assert not os.path.exists(tmp_path / "broken.aea")
    with open(ck) as f:
        assert json.load(f) == {"done": sorted(wavs)}
    again = corpus.transcode_corpus(jobs, chunk_frames=8, checkpoint_path=ck, device="cpu", max_retries=0)
    assert again.skipped == wavs and not again.completed and list(again.failed) == [broken]


def test_corpus_stripes_disjoint_and_complete(corpus_dir, tmp_path):
    _, wavs, _ = corpus_dir
    jobs = [(w, str(tmp_path / f"s{i}.aea")) for i, w in enumerate(wavs)]
    parts = [corpus.transcode_corpus(jobs, chunk_frames=8, process_index=i, process_count=3, device="cpu").completed
             for i in range(3)]
    assert parts == [wavs[0:1], wavs[1:2], wavs[2:3]]
    with pytest.raises(ValueError, match="mode"):
        corpus.transcode_corpus(jobs, mode="transcode", device="cpu")


def test_corpus_checkpoint_read_both_ways(tmp_path):
    """The JSON checkpoint is the JAX package's: each reads the other's."""
    jax_path, port_path = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jck = JaxCheckpoint(jax_path)
    for key in ("b.wav", "a.wav"):
        jck.mark(key)
    assert corpus.Checkpoint(jax_path).done == {"a.wav", "b.wav"}
    pck = corpus.Checkpoint(port_path)
    for key in ("z.wav", "c.wav"):
        pck.mark(key)
    assert JaxCheckpoint(port_path).done == {"c.wav", "z.wav"}
    assert _bytes(port_path) == json.dumps({"done": ["c.wav", "z.wav"]}).encode()
    (tmp_path / "bad.json").write_text("{not json")
    assert corpus.Checkpoint(str(tmp_path / "bad.json")).done == set()


# ---------------------------------------------------------------------------
# Multi-process launcher
# ---------------------------------------------------------------------------
def test_initialize_alone_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() == (0, 1)
    assert not torch.distributed.is_initialized()
    assert multihost.main(["--out-dir", "x"]) == 1                  # neither --encode nor --decode


def test_two_process_gloo_corpus(corpus_dir, tmp_path):
    """Two processes of `python -m carta1_tpu_torch.parallel.multihost` join
    one gloo group and split the files disjointly and completely
    (tests/test_multihost.py for the JAX launcher).  No JAX in the workers."""
    d, wavs, _ = corpus_dir
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out_dir, ck = str(tmp_path / "out"), str(tmp_path / "ck.json")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "carta1_tpu_torch.parallel.multihost", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(pid), "--encode", os.path.join(str(d), "in*.wav"),
         "--out-dir", out_dir, "--checkpoint", ck, "--device", "cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert sorted(o["process"] for o in outs) == [0, 1] and all(o["processes"] == 2 for o in outs)
    assert sorted(o["completed"] for o in outs) == [1, 2] and not any(o["failed"] for o in outs)
    done = [set(json.load(open(f"{ck}.p{i}"))["done"]) for i in range(2)]
    assert done[0].isdisjoint(done[1]) and done[0] | done[1] == set(wavs)
    assert sorted(os.listdir(out_dir)) == [f"in{i}.aea" for i in range(3)]
