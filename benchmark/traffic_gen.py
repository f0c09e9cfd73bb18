"""The one generator of the benchmark's traffic: PCM made on the device
from a seed, by the recipe of a traffic file.

A traffic file (`benchmark/traffic/<name>.json`) fixes everything that
sets the amount and kind of work: the operation (`op`, "encode" or
"decode"), the tracks and channels of a batch (their product is the rows
of every call), the frames of a track, the frames of a call, and the
name of its content recipe, a file of `benchmark/traffic/content/` that
`spec.load_traffic` reads in (`content.kind`, "music" or "drums", and its
fixed structure: how many tones, where the steps or bursts fall).  The
seed draws only values inside the ranges the recipe gives: frequencies, phases, levels, decay
times, noise.  So two seeds give the same shapes, the same positions of
every transient and the same amount of work, with other samples.

Samples are made on the device with a `torch.Generator` seeded from
`--seed`, in a few large calls, and returned as int16 [chunks, rows,
chunk_frames, 512], chunk-major so that each call's input is contiguous.
"""

from __future__ import annotations

import math

import torch

RATE = 44100
FRAME = 512


def shape(traffic: dict) -> tuple[int, int, int, int]:
    """(chunks per track, rows, frames per call, frames per track)."""
    rows = traffic["tracks"] * traffic["channels"]
    total, chunk = traffic["frames_per_track"], traffic["chunk_frames"]
    if total % chunk:
        raise ValueError(f"frames_per_track {total} is not a whole number of chunks of {chunk}")
    return total // chunk, rows, chunk, total


def _uniform(g: torch.Generator, n: tuple, lo_hi, device) -> torch.Tensor:
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(n, generator=g, dtype=torch.float64, device=device)


def _log_uniform(g, n, lo_hi, device) -> torch.Tensor:
    return torch.exp(_uniform(g, n, (math.log(lo_hi[0]), math.log(lo_hi[1])), device))


def _music(c: dict, g: torch.Generator, rows: int, n: int, device) -> torch.Tensor:
    """Tones and a frequency-modulated partial over a noise floor, with a
    step of fixed length at fixed places (synth_audio's recipe, seeded)."""
    t = torch.arange(n, dtype=torch.float64, device=device) / RATE
    k = c["tones"]
    freq = _log_uniform(g, (rows, k), c["tone_hz"], device)
    amp = _uniform(g, (rows, k), c["tone_level"], device)
    phase = _uniform(g, (rows, k), (0.0, 2 * math.pi), device)
    fm = _log_uniform(g, (rows,), c["partial_hz"], device)
    fm_amp = _uniform(g, (rows,), c["partial_level"], device)
    fm_rate = _uniform(g, (rows,), c["vibrato_hz"], device)
    fm_depth = _uniform(g, (rows,), c["vibrato_depth"], device)
    noise_level = _uniform(g, (rows,), c["noise_level"], device)
    step_level = _uniform(g, (rows,), c["step_level"], device)
    out = torch.empty((rows, n), dtype=torch.float32, device=device)
    noise = torch.randn((rows, n), generator=g, dtype=torch.float32, device=device)
    for r in range(rows):                      # one row at a time bounds the f64 temporaries
        sig = torch.zeros(n, dtype=torch.float64, device=device)
        for j in range(k):
            sig += amp[r, j] * torch.sin(torch.remainder(freq[r, j] * t, 1.0) * (2 * math.pi) + phase[r, j])
        sig += fm_amp[r] * torch.sin(2 * math.pi * torch.remainder(fm[r] * t, 1.0)
                                     + fm_depth[r] * torch.sin(2 * math.pi * fm_rate[r] * t))
        out[r] = sig.float()
    out += noise * noise_level[:, None].float()
    first, every, length = c["step_first"], c["step_every"], c["step_len"]
    pos = torch.arange(n, device=device)
    in_step = ((pos - first) % every < length) & (pos >= first)
    out += in_step.float() * step_level[:, None].float()
    return out


def _drums(c: dict, g: torch.Generator, rows: int, n: int, device) -> torch.Tensor:
    """Bursts at a fixed interval, cycling through the file's kinds: each a
    decaying noise burst, shaped by a two-tap filter of the kind's sign
    (+ low-passed, - high-passed), plus a decaying low tone for a kick.
    Levels, decays, filter depth and tone pitch are drawn per row and burst."""
    every, kinds = c["burst_every"], c["kinds"]
    bursts = n // every
    pos = torch.arange(n, device=device)
    idx = pos // every                                  # burst each sample belongs to
    age = (pos % every).double() / RATE                 # seconds since its onset
    kind_of = torch.tensor([kinds[b % len(kinds)]["tilt"] for b in range(len(kinds))], dtype=torch.float64,
                           device=device)[idx % len(kinds)]
    kick_of = torch.tensor([kinds[b % len(kinds)]["kick"] for b in range(len(kinds))], dtype=torch.float64,
                           device=device)[idx % len(kinds)]
    level = _uniform(g, (rows, bursts + 1), c["burst_level"], device)
    decay = _uniform(g, (rows, bursts + 1), c["decay_s"], device)
    depth = _uniform(g, (rows,), c["filter_depth"], device)
    kick_hz = _uniform(g, (rows,), c["kick_hz"], device)
    floor = _uniform(g, (rows,), c["noise_level"], device)
    noise = torch.randn((rows, n + 1), generator=g, dtype=torch.float32, device=device)
    out = torch.empty((rows, n), dtype=torch.float32, device=device)
    for r in range(rows):
        nz = noise[r].double()
        shaped = nz[1:] + kind_of * depth[r] * nz[:-1]
        env = level[r, idx] * torch.exp(-age / decay[r, idx])
        kick = kick_of * torch.sin(2 * math.pi * kick_hz[r] * age)
        out[r] = (env * (shaped + kick) + floor[r] * nz[1:]).float()
    return out


KINDS = {"music": _music, "drums": _drums}


def make(traffic: dict, seed: int, device) -> torch.Tensor:
    """int16 PCM [chunks, rows, chunk_frames, 512] on `device` from `seed`."""
    chunks, rows, chunk, total = shape(traffic)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    content = traffic["content"]
    pcm = KINDS[content["kind"]](content, g, rows, total * FRAME, device)
    pcm = (pcm.clamp(-1.0, 1.0) * 32767.0).round().to(torch.int16)
    return pcm.reshape(rows, chunks, chunk, FRAME).transpose(0, 1).contiguous()
