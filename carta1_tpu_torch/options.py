"""Encoder configuration (parity: codec/core/options.js).

Same four fields, defaults, ranges and validation as the reference, and the
same class as `carta1_tpu/options.py`.  The object is hashable and immutable
after construction, so it can key the per-option tables the encoder caches.

Reference quirk, kept for output comparability: the encoder reads only
`transient_threshold_low` for all three bands (encoder.js:134).  Setting
``per_band_thresholds=True`` honors the mid/high thresholds instead; this is
an extension flag, off by default.
"""

from __future__ import annotations

import dataclasses

# Field names, defaults, ranges and steps must match the reference
# (codec/core/options.js:25-56) for config parity; the display prose is ours.
OPTION_METADATA = {
    "transient_threshold_low": {
        "default": 1.0,
        "name": "Transient threshold, low band",
        "description": (
            "Attack-detection score a 0-5.5 kHz frame must exceed before the "
            "encoder switches that band to short MDCT blocks; smaller values "
            "mean twitchier switching."
        ),
        "range": (0.01, 2.0),
        "step": 0.01,
    },
    "transient_threshold_mid": {
        "default": 1.5,
        "name": "Transient threshold, mid band",
        "description": (
            "Short-block switching score for the 5.5-11 kHz band (only read "
            "when per-band thresholds are enabled; see module docstring)."
        ),
        "range": (0.01, 3.0),
        "step": 0.01,
    },
    "transient_threshold_high": {
        "default": 2.0,
        "name": "Transient threshold, high band",
        "description": (
            "Short-block switching score for the 11-22 kHz band (only read "
            "when per-band thresholds are enabled; see module docstring)."
        ),
        "range": (0.01, 4.0),
        "step": 0.01,
    },
    "allocation_bias": {
        "default": 1.0,
        "name": "Bit allocation bias",
        "description": (
            "Exponent applied to each BFU's scale factor when pricing "
            "word-length upgrades: raising it steers the bit budget toward "
            "high-energy coefficients at the expense of quiet detail."
        ),
        "range": (0.5, 3.0),
        "step": 0.01,
    },
}


@dataclasses.dataclass(frozen=True)
class EncoderOptions:
    transient_threshold_low: float = 1.0
    transient_threshold_mid: float = 1.5
    transient_threshold_high: float = 2.0
    allocation_bias: float = 1.0
    per_band_thresholds: bool = False  # extension; reference behavior is False
    # "rdo": measured-distortion allocator (default; strictly >= reference
    # quality, `ops.bitalloc.allocate_bits_rdo`).  "reference": the reference
    # heap's scale-factor-proxy greedy, for output comparability.
    allocator: str = "rdo"

    def __post_init__(self) -> None:
        for key, meta in OPTION_METADATA.items():
            value = getattr(self, key)
            lo, hi = meta["range"]
            if not (lo <= value <= hi):
                raise ValueError(
                    f"Value for {key} must be between {lo} and {hi}, got {value}"
                )
        if self.allocator not in ("rdo", "reference"):
            raise ValueError(f"allocator must be 'rdo' or 'reference', got {self.allocator!r}")

    def replace(self, **kwargs) -> "EncoderOptions":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in OPTION_METADATA}

    @staticmethod
    def metadata(key: str) -> dict:
        return OPTION_METADATA[key]

    @property
    def band_thresholds(self) -> tuple[float, float, float]:
        """Effective per-band thresholds given the compat flag."""
        if self.per_band_thresholds:
            return (
                self.transient_threshold_low,
                self.transient_threshold_mid,
                self.transient_threshold_high,
            )
        return (self.transient_threshold_low,) * 3
