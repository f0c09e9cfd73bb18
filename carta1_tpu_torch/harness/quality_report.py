"""Encode quality on the card: the port of `quality_report.py` at the repo root.

For each of the six signal classes of `testing.signals()` (3 s, mono), two
round-trip PSNRs against full scale: the gold engine's encode
(`engine="exact"`, units byte-equal to the reference's) and the batched
engine's (`engine="tpu"`), both decoded by the same exact decoder, with
the bitstream round trip included (units to the host and back through
`decode_units`), so only the encoders' decisions differ.  `delta_db` is
batched minus gold; the encode contract wants it at least 0 on every class.

    python -m carta1_tpu_torch.harness.quality_report [--device cpu]

Output: one JSON line per class with `quality_report.py`'s keys, then the
summary line with the worst delta; every line carries `"device"`.  PSNRs
are unrounded.
"""

from __future__ import annotations

import argparse
import json

from carta1_tpu_torch.device import resolve_device
from carta1_tpu_torch.harness.common import device_record
from carta1_tpu_torch.processor import decode_units, encode_pcm
from carta1_tpu_torch.testing import psnr, signals


def round_trip(sig, engine: str, dev) -> float:
    """PSNR of `sig` (f32 [N]) encoded by `engine` and decoded exactly."""
    units = encode_pcm(sig[None], engine=engine, device=dev)
    return psnr(sig, decode_units(units, 1, device=dev)[0].cpu().numpy())


def run(seconds: float = 3.0, device=None) -> list[dict]:
    """The per-class rows, then the summary row."""
    dev = resolve_device(device)
    tag = device_record(dev)
    rows = []
    for name, sig in signals(seconds).items():
        ref, tpu = round_trip(sig, "exact", dev), round_trip(sig, "tpu", dev)
        rows.append({"signal": name, "psnr_reference_encoder_db": ref, "psnr_tpu_encoder_db": tpu,
                     "delta_db": tpu - ref, "seconds": seconds, "device": tag})
    rows.append({"summary": "tpu_minus_reference_worst_delta_db", "value": min(r["delta_db"] for r in rows),
                 "device": tag})
    return rows


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain versions")
    a = p.parse_args(argv)
    rows = run(device=a.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
