"""PyTorch port vs the JAX reference: the host planners field by field, and
the two kernels' plain versions (what a CPU tensor runs) against the
reference's Pallas kernels in interpret mode and their jnp oracles. Every
comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.idl_insert import ops as j_ins_ops  # noqa: E402
from repro.kernels.idl_probe import ops as j_probe_ops  # noqa: E402
from repro_torch.kernels.idl_insert import kernel as ins_kernel  # noqa: E402
from repro_torch.kernels.idl_insert import ops as ins_ops  # noqa: E402
from repro_torch.kernels.idl_insert import ref as ins_ref  # noqa: E402
from repro_torch.kernels.idl_probe import kernel as probe_kernel  # noqa: E402
from repro_torch.kernels.idl_probe import ops as probe_ops  # noqa: E402
from repro_torch.kernels.idl_probe import ref as probe_ref  # noqa: E402


def _assert_same_fields(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in a.__dataclass_fields__:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f
            np.testing.assert_array_equal(va, vb, err_msg=f)
        else:
            assert va == vb, f


def _words(rng, n_rows, w):
    return rng.integers(0, 2 ** 32, size=(n_rows, w), dtype=np.uint64
                        ).astype(np.uint32)


def _tw(words: np.ndarray) -> "torch.Tensor":
    return torch.from_numpy(words.view(np.int32).copy())


# -- planners ----------------------------------------------------------------

@pytest.mark.parametrize("p,n,block,c", [
    (3, 97, 16, 32), (8, 200, 512, 128), (1, 1, 4, 8), (4, 300, 1, 32),
])
def test_plan_probe_runs_field_by_field(rng, p, n, block, c):
    rows = rng.integers(0, 64 * block, size=(p, n))
    rows[0].sort()
    _assert_same_fields(
        probe_ops.plan_probe_runs(rows, block_bits=block, probes_per_run=c),
        j_probe_ops.plan_probe_runs(rows, block_bits=block, probes_per_run=c))


@pytest.mark.parametrize("n,block,c", [
    (900, 512, 32), (5000, 2048, 128), (3, 64, 8), (20000, 1 << 19, 128),
])
def test_plan_insert_runs_field_by_field(rng, n, block, c):
    flat = rng.integers(0, 64 * block, size=n)
    flat[: n // 10] = -1                                 # masked targets
    _assert_same_fields(
        ins_ops.plan_insert_runs(flat, block_bits=block, inserts_per_run=c),
        j_ins_ops.plan_insert_runs(flat, block_bits=block, inserts_per_run=c))


def test_plan_insert_runs_empty_is_none():
    assert ins_ops.plan_insert_runs(np.full(7, -1), 64) is None
    assert j_ins_ops.plan_insert_runs(np.full(7, -1), 64) is None


# -- gather_planned_rows -----------------------------------------------------

@pytest.mark.parametrize("n_rows,w,rpb,c", [
    (256, 3, 16, 32),       # odd word count
    (1 << 12, 1, 64, 128),  # flat packed BF as a (m/32, 1) matrix
    (512, 8, 8, 64),        # wide rows
])
def test_gather_planned_rows_plain_vs_reference(rng, n_rows, w, rpb, c):
    words = _words(rng, n_rows, w)
    rows = rng.integers(0, n_rows, size=(3, 97))
    rows[1].sort()          # one stream with long block runs, two scattered
    plan = probe_ops.plan_probe_runs(rows, block_bits=rpb, probes_per_run=c)
    jplan = j_probe_ops.plan_probe_runs(rows, block_bits=rpb,
                                        probes_per_run=c)
    before = probe_kernel.launches
    got = probe_ops.gather_planned_rows(_tw(words), plan).numpy()
    assert probe_kernel.launches == before      # CPU: plain version, no launch
    got = got.view(np.uint32)
    for kw in (dict(interpret=True), dict(use_ref=True)):
        want = np.asarray(j_probe_ops.gather_planned_rows(
            jnp.asarray(words), jplan, **kw))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, words[rows.reshape(-1)])


def test_gather_planned_rows_ref_direct(rng):
    words = _words(rng, 128, 4)
    plan = probe_ops.plan_probe_runs(rng.integers(0, 128, size=(2, 40)),
                                     block_bits=8, probes_per_run=16)
    got = probe_ref.gather_planned_rows_ref(
        _tw(words), torch.from_numpy(plan.block_ids),
        torch.from_numpy(plan.offsets), torch.from_numpy(plan.probe_index),
        rows_per_block=8, n_probes=plan.n_probes)
    want = np.asarray(j_probe_ops.gather_planned_rows(
        jnp.asarray(words), plan, use_ref=True))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_gather_planned_rows_rejects_foreign_blocks(rng):
    plan = probe_ops.plan_probe_runs(np.array([[0, 200]]), block_bits=8)
    with pytest.raises(ValueError):
        probe_ops.gather_planned_rows(torch.zeros((64, 2), dtype=torch.int32),
                                      plan)


# -- insert_planned ----------------------------------------------------------

@pytest.mark.parametrize("n_rows,w,rpb,c,n_bits", [
    (256, 3, 16, 32, 900), (1 << 12, 1, 64, 128, 3000),
    (512, 8, 8, 40, 777), (64, 32, 64, 128, 5000),
])
def test_insert_planned_plain_vs_reference(rng, n_rows, w, rpb, c, n_bits):
    words = _words(rng, n_rows, w)
    words[rng.random(words.shape) < 0.5] = 0
    flat = rng.integers(0, n_rows * w * 32, size=n_bits)
    flat[:20] = -1
    block_bits = rpb * w * 32
    plan = ins_ops.plan_insert_runs(flat, block_bits=block_bits,
                                    inserts_per_run=c)
    jplan = j_ins_ops.plan_insert_runs(flat, block_bits=block_bits,
                                       inserts_per_run=c)
    mat = _tw(words)
    before = ins_kernel.launches
    out = ins_ops.insert_planned(mat, plan)
    assert ins_kernel.launches == before
    assert out.data_ptr() == mat.data_ptr()     # in place
    want = np.asarray(j_ins_ops.insert_planned(
        jnp.asarray(words), jplan, interpret=True))
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want)
    # the bits that were asked for, and only those, were added
    direct = words.copy().reshape(-1)
    for b in flat[flat >= 0]:
        direct[b >> 5] |= np.uint32(1) << np.uint32(b & 31)
    np.testing.assert_array_equal(want.reshape(-1), direct)


def test_insert_planned_none_plan_is_identity(rng):
    words = _words(rng, 64, 2)
    mat = _tw(words)
    assert ins_ops.insert_planned(mat, None) is mat
    want = np.asarray(j_ins_ops.insert_planned(jnp.asarray(words), None))
    np.testing.assert_array_equal(mat.numpy().view(np.uint32), want)


def test_insert_planned_ref_zero_runs_and_1d(rng):
    words = _words(rng, 256, 1)
    mat = _tw(words)
    ins_ref.insert_planned_ref(mat, torch.empty(0, dtype=torch.int64))
    np.testing.assert_array_equal(mat.numpy().view(np.uint32), words)
    flat = rng.integers(0, 256 * 32, size=300)
    plan = ins_ops.plan_insert_runs(flat, block_bits=128, inserts_per_run=16)
    flat_words = _tw(words).reshape(-1)                  # W == 1 as 1-D
    ins_ops.insert_planned(flat_words, plan)
    want = np.asarray(j_ins_ops.insert_planned(
        jnp.asarray(words), plan, use_ref=True))
    np.testing.assert_array_equal(flat_words.numpy().view(np.uint32),
                                  want.reshape(-1))


# -- the compact plan and the scatter-OR over flat positions -----------------

@pytest.mark.parametrize("n,block,c,span", [
    (900, 512, 32, 64),          # ~28 bits per block: one run each
    (5000, 2048, 128, 16),       # ~312 bits per block: runs of C + a tail
    (3000, 64, 128, 4000),       # many blocks of one or two bits
    (1, 16, 4, 1),               # one position
    (4000, 1 << 19, 128, 2),     # two blocks of ~2000 bits: 16 runs each
])
def test_compact_insert_plan_field_by_field(rng, n, block, c, span):
    flat = rng.integers(0, span * block, size=n)
    flat[: n // 10] = -rng.integers(1, 1 << 40, size=n // 10)   # masked
    want = j_ins_ops.plan_insert_runs(flat, block_bits=block,
                                      inserts_per_run=c)
    got = ins_ops.compact_insert_plan(torch.from_numpy(flat.reshape(2, -1)
                                                       if n % 2 == 0
                                                       else flat), block, c)
    if want is None:
        assert got is None
        return
    assert (got.n_locs, got.n_runs, got.n_tiles, got.dma_bytes) == \
        (want.n_locs, want.n_runs, want.n_tiles, want.dma_bytes)
    assert got.block_bits == block and got.inserts_per_run == c
    lengths = got.run_lengths()
    assert lengths.dtype == want.run_lengths.dtype
    np.testing.assert_array_equal(lengths, want.run_lengths)   # run order
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.unique(flat[flat >= 0]))
    assert got.max_position == int(flat.max())


def test_compact_insert_plan_empty_is_none():
    for flat in (torch.full((7,), -1, dtype=torch.int64),
                 torch.empty((0,), dtype=torch.int64),
                 torch.empty((4, 0), dtype=torch.int64)):
        assert ins_ops.compact_insert_plan(flat, 64) is None
    assert j_ins_ops.plan_insert_runs(np.full(7, -1), 64) is None
    mat = torch.ones((4, 2), dtype=torch.int32)
    assert ins_ops.insert_planned(mat, None) is mat


def test_lane_positions_and_the_plan_bound(rng):
    """A run plan's valid lanes, flattened, are its sorted unique positions
    (pad runs and pad lanes dropped); a compact plan whose largest position
    lies past the words raises before anything is written."""
    flat = rng.integers(0, 40 * 512, size=3000)
    flat[:30] = -1
    plan = j_ins_ops.plan_insert_runs(flat, block_bits=512,
                                      inserts_per_run=32)
    assert plan.block_ids.shape[0] > plan.n_runs          # pad runs exist
    got = ins_kernel.lane_positions(torch.from_numpy(plan.block_ids),
                                    torch.from_numpy(plan.offsets), 512)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.unique(flat[flat >= 0]))
    cplan = ins_ops.compact_insert_plan(torch.from_numpy(flat), 512, 32)
    small = torch.zeros((flat.max() // 32,), dtype=torch.int32)
    with pytest.raises(ValueError):
        ins_kernel.insert_planned(small, cplan)
    assert not small.any()


@pytest.mark.parametrize("n_rows,w,rpb,c,n_bits", [
    (256, 3, 16, 32, 900), (1 << 12, 1, 64, 128, 3000),
    (64, 32, 64, 128, 5000),
])
def test_insert_positions_plain_vs_reference(rng, n_rows, w, rpb, c, n_bits):
    """The compact plan through the plain insert (what a CPU matrix runs)
    against the reference's insert_planned of its run plan over the same
    positions, in interpret mode and through its jnp oracle."""
    words = _words(rng, n_rows, w)
    words[rng.random(words.shape) < 0.5] = 0
    flat = rng.integers(0, n_rows * w * 32, size=n_bits)
    flat[:20] = -1
    jplan = j_ins_ops.plan_insert_runs(flat, block_bits=rpb * w * 32,
                                       inserts_per_run=c)
    cplan = ins_ops.compact_insert_plan(torch.from_numpy(flat),
                                        rpb * w * 32, c)
    mat = _tw(words)
    before = ins_kernel.launches
    assert ins_ops.insert_planned(mat, cplan) is mat           # in place
    assert ins_kernel.launches == before
    for kw in (dict(interpret=True), dict(use_ref=True)):
        want = np.asarray(j_ins_ops.insert_planned(jnp.asarray(words), jplan,
                                                   **kw))
        np.testing.assert_array_equal(mat.numpy().view(np.uint32), want)


def test_insert_planned_unsorted_duplicates_and_bounds(rng):
    """Any order, duplicates and several bits of one word: the same words as
    the reference's oracle over the sorted unique positions; a position
    past the words raises before anything is written."""
    words = _words(rng, 32, 2)
    flat = np.concatenate([rng.integers(0, 32 * 2 * 32, size=400),
                           np.arange(64, 96), [5, 5, 5, -3]])
    rng.shuffle(flat)
    mat = _tw(words)
    ins_kernel.insert_planned(mat, torch.from_numpy(flat))
    jplan = j_ins_ops.plan_insert_runs(flat, block_bits=8 * 2 * 32,
                                       inserts_per_run=32)
    want = np.asarray(j_ins_ops.insert_planned(jnp.asarray(words), jplan,
                                               use_ref=True))
    np.testing.assert_array_equal(mat.numpy().view(np.uint32), want)
    with pytest.raises(ValueError):
        ins_kernel.insert_planned(mat, torch.tensor([3, 32 * 2 * 32]))
    with pytest.raises(ValueError):
        ins_kernel.insert_planned(mat, torch.zeros((2, 2), dtype=torch.int64))
    np.testing.assert_array_equal(mat.numpy().view(np.uint32), want)
