"""The plain reference: it imports nothing of the package under test, and
at a small size on the CPU it gives the package's exact engine's units
byte for byte and its decoder's int16 sample for sample."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.reference import bitstream, decoder, encoder

REF = Path(__file__).resolve().parents[1] / "reference"
ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("path", sorted(REF.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_only_torch_numpy_and_itself(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
            [node.module] if isinstance(node, ast.ImportFrom) and node.module else []
        for n in names:
            assert n.split(".")[0] in {"__future__", "functools", "math", "numpy", "torch", "benchmark"}, n
            if n.startswith("benchmark"):
                assert n.startswith("benchmark.reference"), n


def test_reference_loads_no_module_of_the_package():
    code = ("import sys; import benchmark.reference.decoder, benchmark.reference.encoder, "
            "benchmark.reference.rdo, benchmark.reference.bitstream; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'carta1_tpu_torch', 'carta1_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def _frames(nframes: int = 40) -> torch.Tensor:
    g = torch.Generator().manual_seed(3)
    n = nframes * 512
    t = torch.arange(n, dtype=torch.float64) / 44100
    x = 0.3 * torch.sin(2 * torch.pi * 440 * t) + 0.05 * torch.randn(2, n, generator=g, dtype=torch.float64)
    x[:, 9000:9200] += 0.4                                          # a step: short blocks
    return (x.clamp(-1, 1) * 32767).round().to(torch.int16).reshape(2, nframes, 512)


def test_reference_equals_the_exact_engine_and_the_decoder():
    """Two chunks with the state carried; the first holds short blocks."""
    from carta1_tpu_torch import processor
    from carta1_tpu_torch.options import EncoderOptions

    frames = _frames()
    _, modes, _, _ = encoder.analysis(frames[:, :24].float() / 32768.0, encoder.init_state(2, "cpu"), (1.0,) * 3)
    assert (modes != 0).any()
    st, est, dst, pst = None, encoder.init_state(2, "cpu"), decoder.init_state(2, "cpu"), None
    for part in (frames[:, :24], frames[:, 24:]):
        units, st = processor._encode_batch_dev(part.contiguous(), EncoderOptions(), st, engine="exact")
        ref, est = encoder.encode(part.float() / 32768.0, est, (1.0, 1.0, 1.0), 1.0)
        assert torch.equal(ref, units)
        assert torch.equal(bitstream.pack(bitstream.unpack(units.reshape(-1, 212))).reshape(units.shape), units)
        pcm, pst = processor._decode_batch_dev(units, pst, to_i16=True)
        fields = {k: v.reshape(2, -1, *v.shape[1:]) for k, v in bitstream.unpack(units.reshape(-1, 212)).items()}
        out, dst = decoder.decode(fields, dst)
        assert torch.equal(decoder.to_int16(out), pcm)


def test_heap_allocator_on_ties_and_budgets():
    """The lockstep heap against a plain per-frame heap (the reference's
    loop, written out) on scale factors full of exact ties."""
    g = torch.Generator().manual_seed(5)
    sf = torch.randint(0, 64, (64, 52), generator=g)
    sf[:8] = 30                                                      # 52 equal priorities
    sf[8:16, ::2] = 0                                                # silent BFUs
    sf[16] = 0                                                       # an empty heap
    wl = encoder.allocate_heap(sf, 1.0)
    assert torch.equal(wl, torch.stack([_heap_frame(row.tolist()) for row in sf]))


def _heap_frame(sf: list[int]) -> torch.Tensor:
    from benchmark.reference import tables as T

    prio = encoder.priority_table(1.0)
    heap = [(b, prio[sf[b], 0]) for b in range(52) if sf[b] > 0]
    wl = [0] * 52

    def sift(i):
        iv = heap[i]
        while True:
            left, right, mi, mp = 2 * i + 1, 2 * i + 2, i, iv[1]
            if left < len(heap) and heap[left][1] > mp:
                mi, mp = left, heap[left][1]
            if right < len(heap) and heap[right][1] > mp:
                mi = right
            if mi == i:
                break
            heap[i] = heap[mi]
            i = mi
        heap[i] = iv

    def pop():
        heap[0] = heap[-1]
        heap.pop()
        if heap:
            sift(0)

    for i in range(len(heap) // 2 - 1, -1, -1):
        sift(i)
    remaining = T.BUDGET_BITS
    while remaining > 0 and heap:
        b = heap[0][0]
        cost = int(T.WORD_LENGTH_BITS[wl[b] + 1] - T.WORD_LENGTH_BITS[wl[b]]) * int(T.SPECS_PER_BFU[b])
        if cost > remaining:
            pop()
            continue
        remaining -= cost
        wl[b] += 1
        if wl[b] < 15:
            heap[0] = (b, prio[sf[b], wl[b]])
            sift(0)
        else:
            pop()
    return torch.tensor(wl)
