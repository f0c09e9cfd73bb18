"""carta1_tpu_torch command-line interface (parity: bin/cli.js; the
counterpart of `carta1_tpu/cli.py`).

Same operations and flags as the JAX package's CLI: --encode / --decode /
--json, --quiet, --force, --title, --bias, the transient thresholds, the
allocator, --engine (tpu: the batched encoder; exact: units byte-equal to
the reference's), --chunk-frames, --checkpoint, --profile and
--debug-nans.  --device (default: cuda) takes the place of --platform and
never falls back to the CPU.

Usage:
  python -m carta1_tpu_torch.cli --encode in.wav out.aea
  python -m carta1_tpu_torch.cli --decode in.aea out.wav
  python -m carta1_tpu_torch.cli --json in.aea dump.json
  python -m carta1_tpu_torch.cli --engine exact --encode in.wav out.aea
  python -m carta1_tpu_torch.cli --device cpu --encode in.wav out.aea
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch import profiling
from carta1_tpu_torch.device import resolve_device
from carta1_tpu_torch.framedata import FrameData
from carta1_tpu_torch.io import aea
from carta1_tpu_torch.io.streams import WavStreamReader
from carta1_tpu_torch.ops.bitpack import unpack_frames
from carta1_tpu_torch.options import EncoderOptions
from carta1_tpu_torch.processor import decode_file, encode_file


def _format_time(seconds: float) -> str:
    m, s = divmod(int(seconds), 60)
    return f"{m:02d}:{s:02d}"


def validate_title(title: str) -> None:
    """ASCII-only, max 255 chars (bin/cli.js:57-83)."""
    for i, ch in enumerate(title):
        if ord(ch) > 127:
            raise ValueError(f'Title contains non-ASCII character at position {i}: "{ch}"')
    if len(title) > C.AEA_TITLE_SIZE - 1:
        raise ValueError(
            f"Title is too long ({len(title)} chars). Maximum allowed: {C.AEA_TITLE_SIZE - 1} characters"
        )


class Progress:
    """Frames/s + real-time-multiple readout (bin/cli.js:95-152)."""

    def __init__(self, operation: str, quiet: bool):
        self.operation = operation
        self.quiet = quiet
        self.start = time.perf_counter()

    def __call__(self, done: int, total: int) -> None:
        if self.quiet:
            return
        elapsed = max(time.perf_counter() - self.start, 1e-9)
        fps = done / elapsed
        rt = fps * C.SAMPLES_PER_FRAME / C.SAMPLE_RATE
        pct = 100.0 * done / max(total, 1)
        sys.stderr.write(
            f"\r{self.operation} {pct:5.1f}% | {done}/{total} frames | "
            f"{fps:8.0f} frames/s | RT: {rt:7.1f}x"
        )
        if done >= total:
            sys.stderr.write("\n")
        sys.stderr.flush()


def dump_json(input_aea: str, output_json: str, quiet: bool, device=None) -> None:
    """AEA structure dump (bin/cli.js:503-613), the JAX package's dump field
    for field.  The units are unpacked on `device` (default: the card, kernel
    K3) and the fields come to the host once."""
    dev = resolve_device(device)
    size = os.path.getsize(input_aea)
    with open(input_aea, "rb") as f:
        header = f.read(C.AEA_HEADER_SIZE)
    meta = aea.parse_header(header)
    _, units = aea.read_aea(input_aea)
    # the reference dump iterates the HEADER's frame count and records an
    # error entry for every unit the file can't actually supply
    # (deserializeFrame throws on short reads, cli.js:581-593); read_aea
    # already dropped trailing partials, so those indexes become errors
    frame_count = max(meta.frame_count, units.shape[0]) if meta.frame_count else units.shape[0]
    available = units.shape[0]

    dump = {
        "file": {
            "path": input_aea,
            "size": size,
            "headerSize": C.AEA_HEADER_SIZE,
            "dataSize": size - C.AEA_HEADER_SIZE,
            "expectedDataSize": frame_count * C.SOUND_UNIT_SIZE,
            "sizeDifference": size - C.AEA_HEADER_SIZE - frame_count * C.SOUND_UNIT_SIZE,
        },
        "header": {
            "magic": " ".join(f"{b:02x}" for b in header[:4]),
            "title": meta.title,
            "frameCount": meta.frame_count,
            "channelCount": meta.channel_count,
            "framesPerChannel": meta.frame_count / max(meta.channel_count, 1),
            "duration": (meta.frame_count / max(meta.channel_count, 1)) * 512 / 44100,
        },
        "frames": [],
    }

    fd = unpack_frames(torch.from_numpy(units.copy()).to(dev)).to("cpu")
    n_bfu, block_modes, scale_factors, word_lengths, quantized = (getattr(fd, k).numpy() for k in FrameData.fields())
    sizes = C.SPECS_PER_BFU
    # structural-overrun extension: the reference's bit reader silently
    # truncates fields at the unit boundary (bitstream.js:24,55); flag units
    # whose declared layout doesn't fit the 1696-bit sound unit
    wl_bits = C.WORD_LENGTH_BITS[word_lengths]
    declared_bits = C.FRAME_HEADER_BITS + 10 * n_bfu + (wl_bits * sizes[None, :]).sum(axis=1)
    overrun = declared_bits > C.FRAME_BITS
    for i in range(frame_count):
        offset = C.AEA_HEADER_SIZE + i * C.SOUND_UNIT_SIZE
        if i >= available:
            dump["frames"].append({
                "index": i, "offset": offset, "offsetHex": hex(offset),
                "error": f"Frame must be {C.SOUND_UNIT_SIZE} bytes",
            })
            continue
        n = int(n_bfu[i])
        sf = scale_factors[i, :n]
        wl = word_lengths[i, :n]
        info = {
            "index": i,
            "offset": offset,
            "offsetHex": hex(offset),
            "nBfu": n,
            "blockModes": block_modes[i].tolist(),
            "scaleFactorIndices": sf.tolist(),
            "wordLengthIndices": wl.tolist(),
            "hasNonZeroScaleFactors": bool((sf > 0).any()),
            "hasNonZeroWordLengths": bool((wl > 0).any()),
            "hasCoefficients": bool((quantized[i] != 0).any()),
        }
        if overrun[i]:
            info["error"] = (
                f"Coefficient data overruns sound unit "
                f"({int(declared_bits[i])} > {C.FRAME_BITS} bits)"
            )
        if i < 3 or i == frame_count - 1:
            info["quantizedCoefficients"] = [quantized[i, b, : sizes[b]].tolist() for b in range(n)]
        dump["frames"].append(info)

    # summary filters exactly like the reference (cli.js:599-609)
    errors = sum(1 for fr in dump["frames"] if fr.get("error"))
    silent = sum(
        1
        for fr in dump["frames"]
        if not fr.get("error") and not fr["hasNonZeroScaleFactors"] and not fr["hasNonZeroWordLengths"]
    )
    dump["summary"] = {
        "totalFrames": frame_count,
        "validFrames": frame_count - errors,
        "errorFrames": errors,
        "silentFrames": silent,
        "activeFrames": frame_count - errors - silent,
    }
    dump["stats"] = profiling.stream_stats(fd)
    with open(output_json, "w") as f:
        json.dump(dump, f, indent=2)
    if not quiet:
        print(f"{input_aea} (AEA) -> {output_json} (JSON)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="carta1-torch", description="ATRAC1 Audio Codec (PyTorch/CUDA)")
    p.add_argument("-e", "--encode", action="store_true", help="Encode WAV to AEA")
    p.add_argument("-d", "--decode", action="store_true", help="Decode AEA to WAV")
    p.add_argument("-j", "--json", action="store_true", help="Dump AEA file structure to JSON")
    p.add_argument("-q", "--quiet", action="store_true", help="Suppress all output except errors")
    p.add_argument("-f", "--force", action="store_true", help="Overwrite output file if it exists")
    p.add_argument("-t", "--title", help="Custom title for AEA file metadata (encoding only)")
    p.add_argument("-b", "--bias", type=float, help="Bit allocation bias (default: 1.0)")
    p.add_argument(
        "--threshold-low", type=float, metavar="X",
        help="Transient threshold, low band (default 1.0; the reference applies "
        "this one to ALL bands unless --per-band-thresholds)",
    )
    p.add_argument("--threshold-mid", type=float, metavar="X", help="Transient threshold, mid band (default 1.5)")
    p.add_argument("--threshold-high", type=float, metavar="X", help="Transient threshold, high band (default 2.0)")
    p.add_argument(
        "--per-band-thresholds", action="store_true",
        help="Extension: honor the mid/high thresholds instead of the reference "
        "quirk of applying the low threshold to every band (encoder.js:134)",
    )
    p.add_argument(
        "--allocator", choices=("rdo", "reference"), default="rdo",
        help="Bit allocator: 'rdo' prices word-length steps by measured "
        "quantization error (better quality than the reference on every "
        "measured signal); 'reference' replicates the reference heap's "
        "scale-factor proxy for output comparability",
    )
    p.add_argument("--engine", choices=("tpu", "exact"), default="tpu",
                   help="Codec engine: tpu (the batched encoder, default) or exact (the reference's bytes)")
    p.add_argument("--device", default="cuda", help="Torch device: cuda (default; no fallback) or cpu")
    p.add_argument("--chunk-frames", type=int, default=8192, help="Frames per device batch")
    p.add_argument(
        "--checkpoint",
        metavar="PATH",
        help="Mid-stream checkpoint file: progress + codec state are snapshotted "
        "atomically during transcode, and an interrupted run resumes from it "
        "with byte-identical output",
    )
    p.add_argument("--profile", metavar="DIR", help="Capture a torch.profiler trace into DIR")
    p.add_argument("--debug-nans", action="store_true", help="Raise on any NaN produced in the device pipeline")
    p.add_argument("input", help="Input file path")
    p.add_argument("output", help="Output file path")
    return p


def _options(args) -> EncoderOptions:
    options = EncoderOptions(allocator=args.allocator)
    if args.bias is not None:
        options = options.replace(allocation_bias=args.bias)
    if args.threshold_low is not None:
        options = options.replace(transient_threshold_low=args.threshold_low)
    if args.threshold_mid is not None:
        options = options.replace(transient_threshold_mid=args.threshold_mid)
    if args.threshold_high is not None:
        options = options.replace(transient_threshold_high=args.threshold_high)
    if args.per_band_thresholds:
        options = options.replace(per_band_thresholds=True)
    return options


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    modes = [args.encode, args.decode, args.json]
    if sum(modes) == 0:
        print("Error: Must specify one of --encode, --decode, or --json", file=sys.stderr)
        return 1
    if sum(modes) > 1:
        print("Error: Cannot specify multiple operation modes", file=sys.stderr)
        return 1
    if os.path.exists(args.output) and not args.force:
        print(
            f"Error: Output file '{args.output}' already exists. Use --force to overwrite.",
            file=sys.stderr,
        )
        return 1
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    if args.debug_nans:
        profiling.enable_nan_debugging()
    try:
        with profiling.trace(args.profile, device) if args.profile else contextlib.nullcontext():
            if args.encode:
                options = _options(args)
                title = args.title or os.path.splitext(os.path.basename(args.output))[0]
                validate_title(title)
                with WavStreamReader(args.input) as reader:            # header-only check
                    info = reader.info
                if info.sample_rate != C.SAMPLE_RATE and not args.quiet:
                    print(f"Warning: Input sample rate {info.sample_rate}Hz, expected {C.SAMPLE_RATE}Hz")
                t0 = time.perf_counter()
                result = encode_file(
                    args.input, args.output, options=options, title=title, chunk_frames=args.chunk_frames,
                    on_progress=Progress("Encoding", args.quiet), checkpoint=args.checkpoint, device=device,
                    engine=args.engine,
                )
                if not args.quiet:
                    bitrate = round(C.BITRATE_PER_CHANNEL * result.channels / 1000)
                    elapsed = time.perf_counter() - t0
                    print(
                        f"{args.input} (WAV 44100Hz {result.channels}ch "
                        f"{_format_time(result.duration)}) -> {args.output} (AEA {bitrate}kbps) "
                        f"in {elapsed:.2f}s ({result.duration / elapsed:.1f}x realtime)"
                    )
            elif args.decode:
                t0 = time.perf_counter()
                result = decode_file(
                    args.input, args.output, chunk_frames=args.chunk_frames,
                    on_progress=Progress("Decoding", args.quiet), checkpoint=args.checkpoint, device=device,
                    engine=args.engine,
                )
                if not args.quiet:
                    bitrate = round(C.BITRATE_PER_CHANNEL * result.channels / 1000)
                    elapsed = time.perf_counter() - t0
                    print(
                        f"{args.input} (AEA {bitrate}kbps {result.channels}ch "
                        f"{_format_time(result.duration)}) -> {args.output} (WAV 44100Hz) "
                        f"in {elapsed:.2f}s ({result.duration / elapsed:.1f}x realtime)"
                    )
            else:
                dump_json(args.input, args.output, args.quiet, device)
    except FileNotFoundError as e:
        print(f"Error: File not found - {e.filename}", file=sys.stderr)
        return 1
    except (ValueError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    finally:
        if args.debug_nans:
            profiling.enable_nan_debugging(False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
