"""The program's own stage spans, read for the per-layer metrics of a
traced stretch.

While `torch.profiler` records, `carta1_tpu_torch.profiling.span` opens a
span at each stage of the chunk step (`carta1.encode.step` over
`carta1.encode.qmf`, `.transient`, `.mdct`, `.scale_factors`,
`.allocate`, `.quantize`, `.pack`; `carta1.decode.step` over `.unpack`,
`.dequantize`, `.imdct` (which holds `.short_index`), `.synthesis`), and
`profiling.spans()` lists their records.  After the stretch (each call
ended in a synchronise), this module takes the last `trace.calls` step
records of the cell's operation with their descendants and averages a
span's time or count over those calls.

After `program.py`, this is the second module of the benchmark that
touches the package, and it reads only `profiling.spans`.  A program
without it (an older commit) gives no record: every reader here then
returns None, as it does for a span or a device time that is missing,
and never 0.

A device ms is the time between a span's entry and exit events on the
step's stream: its kernels, plus any wait for the host inside it.  A
host ms under the profiler includes the profiler's own cost per
operation, so it compares only with other traced runs.
"""

from __future__ import annotations


def _records(ctx) -> tuple[int, list[dict]] | None:
    """(calls, the records of the traced stretch's last `calls` steps of
    the cell's operation and of their descendants), or None."""
    from carta1_tpu_torch import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    records = read()
    calls = ctx["trace"].calls
    steps = [r["id"] for r in records if r["name"] == f"carta1.{ctx['op']}.step"][-calls:]
    if len(steps) < calls:
        return None
    steps = set(steps)
    return calls, [r for r in records if r["call"] in steps]


def per_call(op: str, name: str, value):
    """A metric reader: the sum over the span `name`'s records of
    `value(record)` per call, in the cells of operation `op`; None where
    the span or a value is missing."""
    def read(ctx):
        got = _records(ctx) if ctx["op"] == op else None
        if got is None:
            return None
        calls, records = got
        values = [value(r) for r in records if r["name"] == name]
        if not values or any(v is None for v in values):
            return None
        return sum(values) / calls
    return read


def device_ms(op: str, name: str):
    """Device milliseconds per call of the span `name`."""
    return per_call(op, name, lambda r: r["device_ms"])


def host_ms(op: str, name: str):
    """Host milliseconds per call of the span `name`."""
    return per_call(op, name, lambda r: r["host_ms"])


def count(op: str, name: str, key: str):
    """The span `name`'s count `key` per call."""
    return per_call(op, name, lambda r: r["counts"].get(key))
