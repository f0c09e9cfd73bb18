"""The port's bit allocators (K4) on the CPU: the merge the CUDA kernel runs
against the plain version, and the plain version's pinned error sum.

The kernel (`csrc/alloc_sweep.cu`) merges each BFU's list of valid steps
as the reference's max-heap does; the plain version sorts all 780 steps
of a frame and sweeps them (`bitalloc.rdo_candidates` /
`reference_candidates` + `bitalloc_kernels.alloc_sweep_plain`).  Here the
heap (`testing.merge_sweep_reference`) must give the plain version's word
lengths bit for bit, and so must the reference allocator's kernel loop in
NumPy (`testing.bisect_sweep_reference`: the bisected prefix, then the
merge on packed keys, on `bitalloc_kernels.reference_tables`); the plain
error curve must equal a NumPy f32 loop that sums left to right
(`testing.rdo_errors_reference`), the order the kernel repeats.  The kernel itself is held against the plain version
on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).  Imports no
JAX.
"""

import functools

import numpy as np
import pytest
import torch

from carta1_tpu_torch import constants as C
from carta1_tpu_torch import kernels, testing
from carta1_tpu_torch.ops import bitalloc, bitalloc_kernels
from carta1_tpu_torch.tables import RDO_BUDGET

CPU = torch.device("cpu")
RDO_FRAMES = 48                      # the RDO tests' frame count (tests/test_torch_encode.py)
BIASES = (0.7, 1.0, 2.0)


@functools.lru_cache(maxsize=None)
def _inputs(kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    bfu, sf = testing.alloc_inputs(kind, RDO_FRAMES, seed=testing.ALLOC_KINDS.index(kind))
    return torch.from_numpy(bfu), torch.from_numpy(sf)


def _same_f32(a: np.ndarray, b: np.ndarray) -> bool:
    """Bitwise, any NaN equal to any NaN."""
    return a.shape == b.shape and bool(((a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b))).all())


@pytest.mark.parametrize(
    "kind,bias",
    [(k, b) for k in ("random", "exact ties", "NaN and inf", "silent", "all 63") for b in BIASES]
    + [("denormals", 1.0), ("sparse", 1.0)],
)
def test_rdo_merge_equals_sorted_sweep(kind, bias):
    """The heap over per-BFU hull lists, ties to the lower BFU, gives the
    plain version's word lengths; the prices it rests on are non-increasing
    along each BFU's valid steps."""
    bfu, sf = _inputs(kind)
    prio, valid = bitalloc.rdo_priorities(bfu, sf, bias)
    p, v = prio.numpy(), valid.numpy()
    want = bitalloc_kernels.alloc_sweep_plain(bitalloc.rdo_candidates(bfu, sf, bias)).numpy()
    assert np.array_equal(testing.merge_sweep_reference(p, v, RDO_BUDGET), want)
    later = np.where(v[..., 1:], p[..., 1:], -np.inf)
    assert (np.where(v[..., :-1], p[..., :-1], np.inf) >= later).all()


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("kind", ["random", "silent", "all 63"])
def test_reference_merge_equals_sorted_sweep(kind, bias):
    """The reference allocator's priority 1024 - rank through the same heap."""
    _, sf = _inputs(kind)
    rank = bitalloc._rank_table(bias, CPU).numpy()
    prio = (1024 - rank[sf.numpy()]).astype(np.float32)
    valid = np.broadcast_to((sf.numpy() > 0)[..., None], prio.shape)
    want = bitalloc.allocate_bits(sf, bias, plain=True).numpy()
    assert np.array_equal(testing.merge_sweep_reference(prio, valid, RDO_BUDGET), want)


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("kind", testing.ALLOC_KINDS)
def test_reference_bisect_model_equals_sorted_sweep(kind, bias):
    """The reference allocator's kernel loop (bisected prefix, the steps of
    the prefix's rank in BFU order, the merge of the rest on packed keys)
    gives the plain version's word lengths."""
    _, sf = _inputs(kind)
    want = bitalloc_kernels.alloc_reference_plain(sf, bias).numpy()
    tables = bitalloc_kernels.reference_tables(bias)
    counts: dict = {}
    assert np.array_equal(testing.bisect_sweep_reference(sf.numpy(), tables, RDO_BUDGET, counts), want)
    assert (counts["steps"] == int(np.ceil(np.log2(tables["count"].shape[0])))).all()
    assert (counts["pops"] <= RDO_BUDGET).all() and (counts["group"] <= 52).all()


@pytest.mark.parametrize("budget", [-3, 0, 1, 37, 5000])
def test_reference_bisect_model_at_other_budgets(budget):
    """Budgets where nothing fits, where one step at most fits, and where
    every step fits (the bisection's two ends)."""
    _, sf = _inputs("random")
    tables = bitalloc_kernels.reference_tables(1.0)
    want = bitalloc_kernels.alloc_reference_plain(sf, 1.0, budget).numpy()
    assert np.array_equal(testing.bisect_sweep_reference(sf.numpy(), tables, budget), want)
    if budget >= C.WORD_LENGTH_BITS[15] * C.SPECS_PER_BFU.sum():
        assert (want == np.where(sf.numpy() > 0, 15, 0)).all()


@pytest.mark.parametrize("bias", [0.0, 0.7, 1.0, 2.0, 5.0])
def test_reference_key_fields_fit(bias):
    """The kernel's key (1023 - rank) << 12 | (63 - b) << 6 | cost holds a
    rank below 1024 and a cost below 64; its count table counts the steps
    ranked below each rank."""
    from carta1_tpu_torch.tables import RDO_CAND_COST

    rank = bitalloc._rank_table(bias, CPU).numpy()
    assert rank.max() < 1024 and RDO_CAND_COST.max() < 64 and RDO_CAND_COST.min() > 0
    t = bitalloc_kernels.reference_tables(bias)
    assert t["count"].dtype == np.uint8 and t["count"].shape == (rank.max() + 2, 64)
    for r in (0, 1, rank.max() // 2, rank.max(), rank.max() + 1):
        assert np.array_equal(t["count"][r, 1:], (rank[1:] < r).sum(axis=1)) and t["count"][r, 0] == 0
    assert (t["count"][-1, 1:] == 15).all()
    cum = t["specs"][:, None] * t["bits"][None, :]
    assert np.array_equal(np.diff(cum, axis=1).reshape(-1), RDO_CAND_COST)


@pytest.mark.parametrize("bias", BIASES)
def test_rank_table_strictly_increasing_along_steps(bias):
    """What makes the merge equal the reference's sort: within a BFU no two
    steps share a rank, so the sort never orders a BFU's steps by cost."""
    rank = bitalloc._rank_table(bias, CPU).numpy()
    assert rank.shape == (64, 15) and rank.min() >= 0 and rank.max() < 1024
    assert (np.diff(rank, axis=1) > 0).all()


@pytest.mark.parametrize("bias", [0.7, 1.0])
@pytest.mark.parametrize("kind", ["random", "NaN and inf", "denormals", "sparse"])
def test_rdo_errors_sum_left_to_right(kind, bias):
    bfu, sf = _inputs(kind)
    got = bitalloc.rdo_errors(bfu, sf, bias).numpy()
    assert got.dtype == np.float32 and got.shape == (RDO_FRAMES, 52, 16)
    assert _same_f32(got, testing.rdo_errors_reference(bfu.numpy(), sf.numpy(), bias))


def test_alloc_wrappers_take_the_plain_version_on_the_cpu():
    bfu, sf = (x[:8] for x in _inputs("random"))
    before = dict(kernels.LAUNCHES)
    got = bitalloc_kernels.alloc_rdo(bfu, sf, 2.0)
    assert got.dtype == torch.int32 and got.shape == (8, 52)
    assert torch.equal(got, bitalloc_kernels.alloc_sweep_plain(bitalloc.rdo_candidates(bfu, sf, 2.0)))
    assert torch.equal(bitalloc_kernels.alloc_reference(sf, 0.7), bitalloc.allocate_bits(sf, 0.7, plain=True))
    assert kernels.LAUNCHES == before                                  # nothing launched, nothing counted
    assert bitalloc_kernels.alloc_rdo(bfu[:0], sf[:0], 1.0).shape == (0, 52)
    assert bitalloc_kernels.alloc_reference(sf[:0], 1.0).shape == (0, 52)


_BFU = torch.zeros(4, 52, 20)
_SF = torch.zeros(4, 52, dtype=torch.int32)


@pytest.mark.parametrize(
    "call",
    [
        lambda: bitalloc_kernels.alloc_rdo(_BFU.double(), _SF, 1.0),
        lambda: bitalloc_kernels.alloc_rdo(_BFU, _SF.long(), 1.0),
        lambda: bitalloc_kernels.alloc_rdo(_BFU.reshape(4, -1), _SF, 1.0),
        lambda: bitalloc_kernels.alloc_rdo(_BFU[:, :, :19].contiguous(), _SF, 1.0),
        lambda: bitalloc_kernels.alloc_rdo(_BFU[:3], _SF, 1.0),
        lambda: bitalloc_kernels.alloc_rdo(_BFU, torch.zeros(52, 4, dtype=torch.int32).T, 1.0),
        lambda: bitalloc_kernels.alloc_reference(_SF.long(), 1.0),
        lambda: bitalloc_kernels.alloc_reference(_SF[:, :51].contiguous(), 1.0),
        lambda: bitalloc_kernels.alloc_reference(_SF.reshape(-1), 1.0),
    ],
)
def test_alloc_wrappers_reject_bad_inputs(call):
    with pytest.raises(ValueError):
        call()


def test_alloc_edge_cases_do_what_their_names_say():
    block = bitalloc_kernels.BLOCK_FRAMES
    edge = testing.alloc_edge_cases(block)
    assert {1, 2, block - 1, block + 1} <= {bfu.shape[0] for _, bfu, _ in edge}
    assert {name.split(",")[0] for name, _, _ in edge} == set(testing.ALLOC_KINDS)
    cases = {name.split(",")[0]: (bfu, sf) for name, bfu, sf in edge if bfu.shape[0] == block + 1}
    real = C.BFU_SLOT_MASK[None]

    def prices(kind, bias=1.0):
        bfu, sf = (torch.from_numpy(a) for a in cases[kind])
        prio, valid = bitalloc.rdo_priorities(bfu, sf, bias)
        return prio.numpy(), valid.numpy(), bitalloc.allocate_bits_rdo(bfu, sf, bias).numpy()

    bfu, sf = cases["NaN and inf"]
    assert (np.isnan(bfu) & real & (sf > 0)[..., None]).any() and (np.isinf(bfu) & real).any()
    p, v, _ = prices("NaN and inf")
    assert np.isnan(p).any() and v.any()
    assert not prices("silent")[2].any()
    _, v, wl = prices("all 63")
    steps = v.sum(axis=-1)
    assert (wl < steps).any()                                           # the budget ran out first
    used = (C.WORD_LENGTH_BITS[wl] * C.SPECS_PER_BFU).sum(axis=1)
    assert (used <= RDO_BUDGET).all() and (used > RDO_BUDGET - 2 * C.MAX_BFU_SIZE).all()
    p, v, _ = prices("sparse")
    assert ((p[..., 1:] == p[..., :-1]) & v[..., 1:] & v[..., :-1]).any()  # plateaus inside a BFU
    bfu, sf = cases["denormals"]
    tiny = (bfu != 0) & (np.abs(bfu) < np.finfo(np.float32).tiny)
    assert (tiny & real & (sf > 0)[..., None]).any()
    _, _, wl = prices("exact ties")
    broken = 0
    for size in np.unique(C.SPECS_PER_BFU):
        cls = wl[:, C.SPECS_PER_BFU == size]
        assert (np.diff(cls, axis=1) <= 0).all(), size                   # ties go to the lower BFU
        broken += int((cls[:, 0] != cls[:, -1]).any())
    assert broken > 0
