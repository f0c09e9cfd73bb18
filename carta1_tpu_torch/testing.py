"""Seeded inputs for the kernels and the encoder checks.

Edge inputs for the tiled kernels K1 (IMDCT), K2 (QMF taps) and K4 (the
allocators, with NaN and inf among their inputs), the plain sweep's
candidates, NumPy and heap references of the allocators, the test signals
of the encode-quality checks, and the amplitudes around every scale-factor
table value.

One NumPy generator, used by the CPU tests (plain versions against the
gold engine), by the card tests and by `chip_smoke.py` (kernels against
their plain versions).  The batches sit on and around a block's tile of
rows; the values are the ones a tiling or a rounding can get wrong: +0,
-0, f32 denormals, magnitudes whose f64 result rounds to inf at the final
f32 store, and a single nonzero sample at either end of a row.  No row
of `edge_rows` overflows before its last rounding, so no NaN appears and
bitwise comparison stays meaningful.
"""

from __future__ import annotations

import numpy as np

PATTERNS = 8
F32_MAX = float(np.finfo(np.float32).max)


def edge_cases(tile: int) -> list[tuple[int, int]]:
    """(rows, seed) pairs around one block's tile of rows: 1, 2, tile - 1,
    tile + 1 and a prime above several tiles.  A batch smaller than
    PATTERNS comes once per seed, so that it sees every row pattern; a
    larger one holds them all."""
    batches = sorted({1, 2, max(tile - 1, 1), tile + 1, 131})
    return [(b, seed) for b in batches for seed in (range(PATTERNS) if b < PATTERNS else (b,))]


def _denormals(rng: np.random.Generator, n: int) -> np.ndarray:
    bits = rng.integers(1, 1 << 23, n).astype(np.uint32) | (rng.integers(0, 2, n).astype(np.uint32) << 31)
    return bits.view(np.float32)


def edge_rows(batch: int, cols: int, seed: int, big: float) -> np.ndarray:
    """f32 [batch, cols]; row r follows pattern (r + seed) % PATTERNS.

    `big` is the magnitude of the lone samples meant to overflow at the
    consumer's final f32 rounding (and of nothing else)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((batch, cols), np.float32)
    for r in range(batch):
        p = (r + seed) % PATTERNS
        if p == 0:                                            # ordinary spectra over 14 binades
            out[r] = rng.standard_normal(cols) * np.exp2(rng.integers(-10, 4, cols))
        elif p == 1:
            out[r] = 0.0
        elif p == 2:
            out[r] = -0.0
        elif p == 3:
            out[r] = _denormals(rng, cols)
        elif p == 4:                                          # one sample at the row's start
            out[r, 0] = big if r % 2 else -big
        elif p == 5:                                          # one sample at the row's end
            out[r, -1] = -big if r % 2 else big
        elif p == 6:                                          # unit impulses at both ends
            out[r, 0], out[r, -1] = 1.0, -1.0
        else:                                                 # a mix: zeros of both signs, denormals, large values
            row = (rng.standard_normal(cols) * 1e30).astype(np.float32)
            kind = rng.integers(0, 4, cols)
            row[kind == 1] = 0.0
            row[kind == 2] = -0.0
            row[kind == 3] = _denormals(rng, int((kind == 3).sum()))
            out[r] = row
    return out


def imdct_edge_spectra(size: int, batch: int, seed: int) -> np.ndarray:
    """f32 [batch, size/2] spectra for `imdct_mid`.  A lone coefficient of
    0.3 * F32_MAX stays finite through the pre-twiddle and the FFT stages
    (each scales it by at most sqrt(8)) and overflows in the post-twiddle."""
    return edge_rows(batch, size >> 1, seed, 0.3 * F32_MAX)


def qmf_edge_bands(frames: int, s: int, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(low, high f32 [frames, s], delay f32 [46]) for `qmf_synthesis_exact`.

    low and high follow `edge_rows` with different seeds; in every other
    frame of the last pattern both bands are +-F32_MAX with the signs of a
    synthesis window, so one merged stream is +-F32_MAX (finite) and its
    tap sum, about 1.8 * F32_MAX in f64, rounds to inf."""
    from carta1_tpu_torch.constants import QMF_EVEN, QMF_ODD

    low = edge_rows(frames, s, seed, F32_MAX)
    high = edge_rows(frames, s, seed + 3, F32_MAX)
    for r in range(frames):
        if (r + seed) % PATTERNS == PATTERNS - 1 and r % 2:
            odd = r % 4 == 3                                   # the odd stream is 0.5 * (low - high)
            signs = np.where((QMF_ODD if odd else QMF_EVEN) < 0, -1.0, 1.0).astype(np.float32)
            low[r] = F32_MAX * np.resize(signs, s)
            high[r] = -low[r] if odd else low[r]
    delay = edge_rows(1, 46, seed + 5, F32_MAX)[0]
    return low, high, delay


def qmf_edge_work(frames: int, s: int, seed: int) -> np.ndarray:
    """f32 [frames, 46 + 2s]: the halo-prefixed merged stream `qmf_taps`
    takes, built from `qmf_edge_bands` as the decoder builds it.  Frames
    shorter than the halo (2s < 46) cannot chain; each then gets a halo of
    its own from `edge_rows`."""
    from carta1_tpu_torch.constants import QMF_DELAY

    low, high, delay = qmf_edge_bands(frames, s, seed)
    lv, hv = low.astype(np.float64), high.astype(np.float64)
    merged = np.stack([0.5 * (lv + hv), 0.5 * (lv - hv)], axis=-1).astype(np.float32).reshape(frames, 2 * s)
    if 2 * s >= QMF_DELAY:
        halo = np.concatenate([delay[None], merged[:-1, -QMF_DELAY:]])
    else:
        halo = edge_rows(frames, QMF_DELAY, seed + 5, F32_MAX)
    return np.concatenate([halo, merged], axis=1)


# ---------------------------------------------------------------------------
# The plain version's sweep (half of K4's plain version)
# ---------------------------------------------------------------------------
def _pack_cands(bfu, cost, valid) -> np.ndarray:
    return ((np.asarray(bfu) << 13) | (np.asarray(cost) << 1) | np.asarray(valid)).astype(np.int32)


def sweep_edge_cases(block: int) -> list[tuple[str, np.ndarray]]:
    """(name, candidates int32 [F, M]) for `alloc_sweep_plain`, each
    candidate packed bfu << 13 | cost << 1 | valid.  The sweep does not need
    its candidates in priority order, so most cases shuffle the 780 real
    (bfu, cost) steps per frame, which exercises the abandon rule hard.
    The batches lie around `block` frames."""
    from carta1_tpu_torch.tables import RDO_BUDGET, RDO_CAND_BFU, RDO_CAND_COST

    rng = np.random.default_rng(404)
    ncand = RDO_CAND_BFU.size

    def shuffled(frames: int, p_valid: float = 0.8) -> np.ndarray:
        order = np.argsort(rng.random((frames, ncand)), axis=1)
        valid = (rng.random((frames, ncand)) < p_valid).astype(np.int32)
        return _pack_cands(RDO_CAND_BFU[order], RDO_CAND_COST[order], valid)

    cases = [(f"shuffled, {f} frames", shuffled(f)) for f in sorted({1, 2, block - 1, block, block + 1, 2 * block + 3})]
    cases.append(("all candidates invalid", shuffled(block + 1, p_valid=0.0)))
    # every step costs more than the whole budget: each BFU is abandoned at its first step
    cases.append(("every BFU abandoned at once", _pack_cands(
        np.tile(RDO_CAND_BFU, (5, 1)), np.full((5, ncand), 0xFFF), np.ones((5, ncand), np.int32))))
    # BFU 0 takes the whole budget in one step; BFU 1's 1-bit step no longer
    # fits and abandons it; zero-cost steps of BFUs 2 and 1 still come: 2 takes them, 1 does not
    exact = np.zeros((3, 8), np.int32)
    exact[:] = _pack_cands([0, 1, 2, 2, 1, 0, 3, 2], [RDO_BUDGET, 1, 0, 0, 0, 1, 0, 0], [1, 1, 1, 1, 1, 1, 0, 1])
    cases.append(("budget met exactly, then zero-cost steps", exact))
    cases.append(("zero-cost steps only", _pack_cands(
        rng.integers(0, 52, (block + 2, ncand)), np.zeros((block + 2, ncand), np.int32),
        rng.integers(0, 2, (block + 2, ncand)))))
    # widths that are no multiple of the kernel's tile, and BFU fields past 51 (ignored in the output)
    for m in (1, 31, 33, 100):
        cases.append((f"{m} candidates, BFU fields up to 63", _pack_cands(
            rng.integers(0, 64, (7, m)), rng.integers(0, 300, (7, m)), rng.integers(0, 2, (7, m)))))
    return cases


def sweep_reference(cands: np.ndarray, budget: int) -> np.ndarray:
    """The sweep as a plain Python loop (gold/coding.py allocate_bits_sweep,
    lines 196-211), the yardstick of `alloc_sweep_plain`: int32 [F, 52]."""
    out = np.zeros((cands.shape[0], 64), np.int32)
    for f, row in enumerate(cands):
        remaining, abandoned = budget, set()
        for c in row.tolist():
            bfu, cost, valid = (c >> 13) & 63, (c >> 1) & 0xFFF, c & 1
            if not valid or bfu in abandoned:
                continue
            if cost > remaining:
                abandoned.add(bfu)
                continue
            remaining -= cost
            out[f, bfu] += 1
    return out[:, :52]


# ---------------------------------------------------------------------------
# K4: the allocators, whole
# ---------------------------------------------------------------------------
ALLOC_KINDS = ("random", "exact ties", "NaN and inf", "silent", "all 63", "denormals", "sparse")


def alloc_inputs(kind: str, frames: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(bfu_data f32 [frames, 52, 20], sf_idx int32 [frames, 52]) of one kind:
    - random: spectra over 14 binades, each BFU's scale factor near its peak's
      (one off either way, a tenth of them 0), padding slots filled too;
    - exact ties: every BFU holds the same coefficients and scale factor, so
      the steps of BFUs of one size tie exactly; six loudness levels;
    - NaN and inf: random, with NaN, +-inf and +-F32_MAX in a tenth of the
      BFUs (and NaN in padding slots, which the allocators never read);
    - silent: every scale factor 0 (nothing valid);
    - all 63: every scale factor 63 and loud spectra (the budget runs out early);
    - denormals: random, with f32 denormals or zeros of both signs in half
      the slots and whole BFUs of denormals (their scale factor 1);
    - sparse: one or two nonzero coefficients per BFU, whose error curves are
      far from convex, so the hull makes plateaus inside a BFU."""
    from carta1_tpu_torch.constants import BFU_SLOT_MASK, SCALE_FACTORS

    rng = np.random.default_rng(seed)
    shape = (frames, 52, 20)
    bfu = rng.standard_normal(shape) * np.exp2(rng.integers(-10, 4, shape))

    def near_peak(x: np.ndarray) -> np.ndarray:
        peak = np.where(BFU_SLOT_MASK, np.abs(x), 0).max(axis=-1)
        idx = np.searchsorted(SCALE_FACTORS, peak) + rng.integers(-1, 2, peak.shape)
        return np.clip(idx, 0, 63)

    if kind == "exact ties":
        proto = rng.standard_normal(20) * 0.2
        bfu = np.broadcast_to(np.where(BFU_SLOT_MASK, proto, 0), shape) * np.exp2(-(np.arange(frames) % 6))[:, None, None]
        peak = np.abs(bfu[:, 0]).max(axis=-1)
        sf = np.broadcast_to(np.searchsorted(SCALE_FACTORS, peak)[:, None], (frames, 52))
    elif kind == "silent":
        sf = np.zeros((frames, 52))
    elif kind == "all 63":
        bfu = rng.uniform(-1.0, 1.0, shape)
        sf = np.full((frames, 52), 63)
    elif kind == "denormals":
        pick = rng.random(shape)
        bfu[pick < 0.4] = _denormals(rng, int((pick < 0.4).sum()))
        bfu[(pick >= 0.4) & (pick < 0.5)] = -0.0
        bfu[:, ::3] = _denormals(rng, bfu[:, ::3].size).reshape(bfu[:, ::3].shape)   # whole BFUs of denormals
        sf = np.where(rng.random((frames, 52)) < 0.1, 0, np.maximum(near_peak(bfu), 1))
    elif kind == "sparse":
        bfu = np.zeros(shape)
        sf = rng.integers(10, 64, (frames, 52))
        amp = SCALE_FACTORS[sf] * rng.choice([1.0, 0.9, 0.5, 0.26, 1 / 3], (frames, 52))
        for k in range(2):
            slot = rng.integers(0, 4, (frames, 52))
            np.put_along_axis(bfu, slot[..., None] + 4 * k, (amp * rng.choice([1, -1, 0], (frames, 52)))[..., None], -1)
    else:
        sf = np.where(rng.random((frames, 52)) < 0.1, 0, near_peak(bfu))
        if kind == "NaN and inf":
            fi, bi = np.nonzero(rng.random((frames, 52)) < 0.1)
            bfu[fi, bi, rng.integers(0, 4, fi.size)] = rng.choice([np.nan, np.inf, -np.inf, F32_MAX, -F32_MAX], fi.size)
            bfu[:, :, 19][rng.random((frames, 52)) < 0.5] = np.nan
        elif kind != "random":
            raise ValueError(f"unknown kind {kind!r}; one of {ALLOC_KINDS}")
    return bfu.astype(np.float32), np.ascontiguousarray(sf, dtype=np.int32)


def alloc_edge_cases(block: int) -> list[tuple[str, np.ndarray, np.ndarray]]:
    """(name, bfu_data, sf_idx) for `alloc_rdo` and `alloc_reference`: random
    inputs in batches of 1, 2, block - 1, block + 1 and 131 frames, and every
    other kind of `alloc_inputs` at block + 1 and 131 frames.  `block` is the
    number of frames one block of the kernel takes."""
    cases = [(f"random, {f} frames", *alloc_inputs("random", f, f)) for f in sorted({1, 2, max(block - 1, 1), block + 1, 131})]
    for i, kind in enumerate(ALLOC_KINDS[1:]):
        cases += [(f"{kind}, {f} frames", *alloc_inputs(kind, f, 100 + 2 * i + j)) for j, f in enumerate((block + 1, 131))]
    return cases


def rdo_errors_reference(bfu: np.ndarray, sf: np.ndarray, bias: float) -> np.ndarray:
    """`bitalloc.rdo_errors` in NumPy f32, the squared errors summed left to
    right over the 20 slots in a Python loop: f32 [F, 52, 16]."""
    from carta1_tpu_torch.constants import BFU_SLOT_MASK, SCALE_FACTORS
    from carta1_tpu_torch.tables import QUANT_RANGES

    f32 = np.float32
    sf32 = SCALE_FACTORS.astype(f32)[sf]
    ranges = QUANT_RANGES.astype(f32)
    active = (sf > 0)[..., None] & (ranges > 0)
    out = np.empty((*sf.shape, 16), f32)
    with np.errstate(all="ignore"):
        norm = np.where(active, ranges / np.where(sf32 > 0, sf32, f32(1))[..., None], f32(0))
        step = np.where(active, sf32[..., None] / np.maximum(ranges, f32(1)), f32(0))
        data = np.where(BFU_SLOT_MASK, bfu, f32(0))
        for wl in range(16):
            x = data * norm[..., wl:wl + 1]
            q = np.clip(np.trunc(x + np.where(x >= 0, f32(0.5), f32(-0.5))), -ranges[wl], ranges[wl])
            d = data - q * step[..., wl:wl + 1]
            acc = d[..., 0] * d[..., 0]
            for k in range(1, 20):
                acc = acc + d[..., k] * d[..., k]
            out[..., wl] = acc
        if bias != 1.0:
            out *= (SCALE_FACTORS.astype(f32) ** f32(bias - 1.0)).astype(f32)[sf][..., None]
    return out


def merge_sweep_reference(prio: np.ndarray, valid: np.ndarray, budget: int) -> np.ndarray:
    """The allocators' sweep as the reference's max-heap (bitallocation.js
    78-164): per frame each BFU's valid steps (prio f32 [F, 52, 15], valid
    bool [F, 52, 15]) form a list in step order; the heap holds each list's
    head keyed (-price, BFU), so equal prices go to the lower BFU; a popped
    step that fits is paid for and its list advances, one that does not
    abandons its BFU.  int32 [F, 52] word lengths."""
    import heapq

    from carta1_tpu_torch.tables import RDO_CAND_COST

    cost = RDO_CAND_COST.reshape(52, 15)
    out = np.zeros(valid.shape[:2], np.int32)
    for f in range(valid.shape[0]):
        heap: list[tuple[float, int, int]] = []

        def push(b: int, start: int) -> None:
            later = np.flatnonzero(valid[f, b, start:])
            if later.size:
                p = start + int(later[0])
                heapq.heappush(heap, (-float(prio[f, b, p]), b, p))

        for b in range(52):
            push(b, 0)
        remaining = budget
        while heap:
            _, b, p = heapq.heappop(heap)
            if cost[b, p] > remaining:
                continue
            remaining -= int(cost[b, p])
            out[f, b] += 1
            push(b, p + 1)
    return out


# ---------------------------------------------------------------------------
# Encoder checks
# ---------------------------------------------------------------------------
def scale_factor_edge_amplitudes(ulps: int = 4) -> np.ndarray:
    """f32 [64 * (2 * ulps + 1)]: for every scale-factor table value
    2^(i/3 - 21), the f32 values from `ulps` below its f32 rounding to
    `ulps` above: where ceil(3 * (log2(a) + 21)) changes its mind."""
    from carta1_tpu_torch.constants import SCALE_FACTORS

    out = []
    for v in SCALE_FACTORS:
        a = np.float32(v)
        for _ in range(ulps):
            a = np.nextafter(a, np.float32(0))
        for _ in range(2 * ulps + 1):
            out.append(a)
            a = np.nextafter(a, np.float32(np.inf))
    return np.array(out, np.float32)


def scale_factor_faults(got: np.ndarray, want: np.ndarray, peaks: np.ndarray, atol: float = 1e-7) -> int:
    """How many scale factor indices of an f32-MDCT encoder (`got`, int
    [F, 52], with the BFU peaks f32 [F, 52] it computed) differ from the gold
    engine's (`want`) for another reason than rounding: an index may be one
    off where the peak lies within `atol` (about two f32 ulps of full
    scale: the rounding floor of an f32 transform; the measured distances
    are below 4e-9) of the table value that separates the two indices.  The
    JAX encoder differs from the gold engine in exactly such places."""
    from carta1_tpu_torch.constants import SCALE_FACTORS

    got, want = got.astype(np.int64), want.astype(np.int64)
    boundary = SCALE_FACTORS[np.minimum(got, want)]
    excused = (np.abs(got - want) == 1) & (np.abs(peaks.astype(np.float64) - boundary) <= atol)
    return int(((got != want) & ~excused).sum())


def backend_agreement(got: dict, want: dict, peaks: np.ndarray, min_equal: float = 0.99) -> dict:
    """Two encodes of the same frames by the port, one of them (partly) on
    the CPU and the other on the card (fields as NumPy arrays [..., F, ...],
    with the BFU peaks f32 [..., F, 52] of `want`'s analysis).  The f32
    coefficients of the two backends differ in their last bits, so the
    allocator breaks some near ties the other way and a scale factor may
    round across a table value (phase 5 of chip_smoke.py measures it on the
    six signal classes; on an H100 at least 0.9986 of the word lengths and
    0.9995 of the quantized values were equal).  Raises AssertionError unless block modes
    are equal, scale factors differ only where `scale_factor_faults`
    excuses them, and at least `min_equal` of the word lengths and of the
    quantized values are equal.  Returns the shares equal."""
    if not np.array_equal(got["block_modes"], want["block_modes"]):
        raise AssertionError("block modes differ between the backends")
    faults = scale_factor_faults(got["scale_factors"], want["scale_factors"], peaks)
    out = {"scale_factor_faults": faults,
           "scale_factors_differing": int((got["scale_factors"] != want["scale_factors"]).sum()),
           "word_lengths_equal": float((got["word_lengths"] == want["word_lengths"]).mean()),
           "quantized_equal": float((got["quantized"] == want["quantized"]).mean())}
    if faults or out["word_lengths_equal"] < min_equal or out["quantized_equal"] < min_equal:
        raise AssertionError(f"the two backends' encodes disagree beyond rounding: {out}")
    return out


def signals(seconds: float = 3.0) -> dict[str, np.ndarray]:
    """The six signal classes of the encode-quality report
    (`quality_report.py` `signals`), f32 in [-1, 1], regenerated from their seed."""
    n = int(44100 * seconds)
    t = np.arange(n) / 44100.0
    rng = np.random.default_rng(7)
    out = {}
    out["sine_440"] = 0.7 * np.sin(2 * np.pi * 440 * t)
    out["sine_mix"] = (
        0.4 * np.sin(2 * np.pi * 220 * t)
        + 0.25 * np.sin(2 * np.pi * 3000 * t)
        + 0.15 * np.sin(2 * np.pi * 9500 * t)
    )
    out["chirp"] = 0.6 * np.sin(2 * np.pi * (50 * t + (8000 - 50) * t * t / (2 * seconds)))
    noise = rng.standard_normal(n)
    out["white_noise"] = 0.3 * noise
    transient = 0.5 * np.sin(2 * np.pi * 500 * t)
    for pos in range(4410, n, 11025):
        transient[pos:pos + 300] += 0.4 * np.hanning(min(300, n - pos))
    out["transients"] = transient
    lp = np.convolve(noise, np.ones(32) / 32, mode="same")
    out["pink_ish"] = 0.5 * lp / np.abs(lp).max()
    return {k: np.clip(v, -1, 1).astype(np.float32) for k, v in out.items()}


def psnr(ref: np.ndarray, out: np.ndarray, delay: int = 266) -> float:
    """Round-trip PSNR against full scale, in dB, after the codec's delay."""
    n = len(ref) - delay
    err = out[delay:delay + n].astype(np.float64) - ref[:n].astype(np.float64)
    return float(10 * np.log10(1.0 / max(np.mean(err**2), 1e-30)))


def synth_audio(nframes: int, channels: int = 2) -> np.ndarray:
    """Deterministic music-like signal, f32 [channels, nframes * 512]: tones,
    noise and periodic transients that exercise the short-block path
    (`bench.py` `synth_audio`)."""
    n = nframes * 512
    t = np.arange(n, dtype=np.float64) / 44100.0
    rng = np.random.default_rng(42)
    out = np.zeros((channels, n), np.float32)
    for ch in range(channels):
        sig = (
            0.35 * np.sin(2 * np.pi * (220 + 110 * ch) * t)
            + 0.2 * np.sin(2 * np.pi * (3000 + 500 * ch) * t + 0.1 * np.sin(2 * np.pi * 3 * t))
            + 0.1 * rng.standard_normal(n)
        )
        for pos in range(2048, n, 44100 // 3):
            sig[pos:pos + 256] += 0.3
        out[ch] = np.clip(sig, -1, 1).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# The exact engine: K5's edge inputs and the byte fixture
# ---------------------------------------------------------------------------
EXACT_CLASS_FRAMES = 32                   # frames of each signal class in the fixture
EXACT_BIAS_CLASSES = ("sine_mix", "transients")
EXACT_BIASES = (0.7, 2.0)


def heap_edge_cases(block: int) -> list[tuple[str, np.ndarray, int]]:
    """(name, sf_idx int32 [F, 52], budget) for K5 (`heap_kernels.alloc_heap`):
    the scale factors of every `alloc_edge_cases` input (exact ties, silent,
    all 63, sparse, ...) with the codec's budget, and heaps of 0, 1, 2 and
    52 entries: one BFU alone (it reaches the top word length and leaves
    bits), two that tie and two that do not, 52 equal ones; then the eight
    8-slot BFUs (1024 bits to reach the top) with budgets that run out one
    bit before, exactly at and one bit after the last step, and budgets of
    0, 1 and 2.  `block` is the frames one block of the kernel takes."""
    from carta1_tpu_torch.constants import SPECS_PER_BFU
    from carta1_tpu_torch.tables import RDO_BUDGET

    cases = [(name, sf, RDO_BUDGET) for name, _, sf in alloc_edge_cases(block)]
    rng = np.random.default_rng(505)
    one = np.zeros((52, 52), np.int32)
    one[np.arange(52), np.arange(52)] = rng.integers(1, 64, 52)
    cases.append(("one BFU in the heap, each BFU in turn", one, RDO_BUDGET))
    two = np.zeros((3 * block + 1, 52), np.int32)
    for r in range(two.shape[0]):
        a, b = rng.choice(52, 2, replace=False)
        two[r, a] = rng.integers(1, 64)
        two[r, b] = two[r, a] if r % 2 else rng.integers(1, 64)
    cases.append(("two BFUs in the heap, tied in every other frame", two, RDO_BUDGET))
    cases.append(("52 equal BFUs", np.tile(np.arange(1, 64, 3, dtype=np.int32)[:, None], (1, 52)), RDO_BUDGET))
    eight = np.where(SPECS_PER_BFU == 8, rng.integers(1, 64, (block + 3, 52)), 0).astype(np.int32)
    for budget in (1023, 1024, 1025, 0, 1, 2):
        cases.append((f"eight 8-slot BFUs, budget {budget}", eight, budget))
    return cases


def heap_edge_peaks(sf_idx: np.ndarray) -> np.ndarray:
    """f32 [F, 52, 20] BFU data whose scale factor indices (by the gold
    engine's ceil(3 * (log2(peak) + 21))) are `sf_idx`: each BFU's peak is
    the largest f32 at or below its table value, in its first slot."""
    from carta1_tpu_torch.constants import SCALE_FACTORS

    v = SCALE_FACTORS.astype(np.float32)
    v = np.where(v.astype(np.float64) > SCALE_FACTORS, np.nextafter(v, np.float32(0)), v)
    out = np.zeros((*sf_idx.shape, 20), np.float32)
    out[..., 0] = np.where(sf_idx > 0, v[sf_idx], 0)
    return out


def exact_expect(path: str) -> dict:
    """`tests/fixtures/torch_exact_expect.npz`: the stored f32 input frames
    and the gold engine's units (`tools/make_torch_exact_fixture.py`).
    Returns {"inputs": {name: f32 [F, 512]}, "units": {(name, bias): uint8
    [F, 212]}}: the golden signal ("golden", 87 frames, bias 1.0), the six
    signal classes (their first EXACT_CLASS_FRAMES frames, bias 1.0) and
    EXACT_BIAS_CLASSES at EXACT_BIASES.  The inputs are stored, not made
    again, because a signal built through NumPy's sin may differ in its
    last bits on another machine."""
    out: dict = {"inputs": {}, "units": {}}
    with np.load(path) as z:
        for key in z.files:
            name, what = key.split("/")
            if what == "frames":
                out["inputs"][name] = z[key]
            else:
                out["units"][(name, float(what.split("_")[1]))] = z[key]
    return out
