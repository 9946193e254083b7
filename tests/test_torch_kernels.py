"""PyTorch port vs the JAX reference: the host planners field by field, and
the two kernels' plain versions (what a CPU tensor runs) against the
reference's Pallas kernels in interpret mode and their jnp oracles. Every
comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.index import query as j_query  # noqa: E402
from repro.kernels.idl_insert import ops as j_ins_ops  # noqa: E402
from repro.kernels.idl_probe import ops as j_probe_ops  # noqa: E402
from repro_torch.kernels.idl_insert import kernel as ins_kernel  # noqa: E402
from repro_torch.kernels.idl_insert import ops as ins_ops  # noqa: E402
from repro_torch.kernels.idl_insert import ref as ins_ref  # noqa: E402
from repro_torch.kernels.idl_probe import kernel as probe_kernel  # noqa: E402
from repro_torch.kernels.idl_probe import ops as probe_ops  # noqa: E402
from repro_torch.kernels.idl_probe import ref as probe_ref  # noqa: E402
from repro_torch.kernels.rambo_merge import kernel as merge_kernel  # noqa: E402
from repro_torch.index import query as t_query  # noqa: E402


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
    """The plain version straight on a run plan's rows, put back into probe
    order as keys of one repetition each, against the reference's gather
    through its jnp oracle."""
    words = _words(rng, 128, 4)
    plan = probe_ops.plan_probe_runs(rng.integers(0, 128, size=(2, 40)),
                                     block_bits=8, probes_per_run=16)
    rows = probe_ops.probe_order(plan, 16, "cpu")
    assert rows.shape == (2, 40) and rows.dtype == torch.int64
    got = probe_ref.gather_and_ref(_tw(words), rows.reshape(1, -1))
    want = np.asarray(j_probe_ops.gather_planned_rows(
        jnp.asarray(words), plan, use_ref=True))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_gather_planned_rows_rejects_foreign_blocks(rng):
    plan = probe_ops.plan_probe_runs(np.array([[0, 200]]), block_bits=8)
    with pytest.raises(ValueError):
        probe_ops.gather_planned_rows(torch.zeros((64, 2), dtype=torch.int32),
                                      plan)


# -- the compact probe plan and the AND over eta ----------------------------

def _probe_stream(rng, p, n, block, kind, c=None):
    if kind == "long_runs":              # sorted: runs split at C
        return np.sort(rng.integers(0, 3 * block, size=(p, n)), axis=1)
    if kind == "repeat_across":          # a stream ends in the next's block
        rows = np.sort(rng.integers(0, 2 * block, size=(p, n)), axis=1)
        rows[1:, 0] = rows[:-1, -1]
        return rows
    if kind == "split":                  # segments of C + 1 to 3C probes
        lengths = rng.integers(c + 1, 3 * c + 1, size=p * n // (c + 1) + 1)
        blocks = np.repeat(np.arange(lengths.size), lengths)[:p * n]
        return (blocks * block + rng.integers(0, block, size=p * n)
                ).reshape(p, n)
    if kind == "one_block":              # every stream in block 0
        return rng.integers(0, block, size=(p, n))
    return rng.integers(0, 64 * block, size=(p, n))


@pytest.mark.parametrize("p,n,block,c,kind", [
    (3, 97, 16, 8, "long_runs"),         # runs of ~16 split at C = 8
    (8, 200, 512, 128, "scattered"),
    (1, 1, 4, 8, "scattered"),           # a one-probe stream
    (1, 300, 64, 32, "long_runs"),       # P = 1
    (4, 50, 32, 128, "repeat_across"),   # blocks repeat across streams
    (6, 40, 1, 32, "scattered"),
])
def test_compact_probe_plan_field_by_field(rng, p, n, block, c, kind):
    rows = _probe_stream(rng, p, n, block, kind)
    want = j_probe_ops.plan_probe_runs(rows, block_bits=block,
                                       probes_per_run=c)
    if kind == "repeat_across":          # two runs in a row, one block
        assert (want.block_ids[:-1] == want.block_ids[1:]).any()
    if kind == "long_runs":
        assert (want.run_lengths == c).any()
    before = _probe_plans()
    got = probe_ops.compact_probe_plan(torch.from_numpy(rows), block, c)
    assert _probe_plans() == {"plain": before["plain"] + 1,
                              "kernel": before["kernel"]}
    assert (got.n_runs, got.n_probes, got.eta, got.n_keys) == \
        (want.n_runs, want.n_probes, want.eta, want.n_keys)
    assert (got.block_bits, got.probes_per_run) == (block, c)
    assert (got.min_row, got.max_row) == (rows.min(), rows.max())
    lengths = got.run_lengths()
    assert lengths.dtype == want.run_lengths.dtype
    np.testing.assert_array_equal(lengths, want.run_lengths)   # run order
    assert got.rows.dtype == torch.int64
    np.testing.assert_array_equal(got.rows.numpy(), rows)
    # a (B, eta, n) stream plans as its (B * eta, n) streams
    if p % 2 == 0:
        cube = probe_ops.compact_probe_plan(
            torch.from_numpy(rows.reshape(2, p // 2, n)), block, c)
        assert (cube.n_runs, cube.eta) == (want.n_runs, want.eta)
        np.testing.assert_array_equal(cube.run_lengths(), want.run_lengths)


def _probe_plans():
    """``{path: n}`` compact plans counted in ``index.probe_plans`` so far."""
    from repro_torch.obs import metrics as t_metrics

    snap = t_metrics.DEFAULT.snapshot()
    return {p: t_metrics.counter_total(snap, "index.probe_plans",
                                       {"path": p})
            for p in ("kernel", "plain")}


@pytest.mark.parametrize("p,n,block,c,kind", [
    (3, 97, 16, 8, "long_runs"),         # the compact plan's shapes
    (8, 200, 512, 128, "scattered"),
    (1, 1, 4, 8, "scattered"),           # one probe
    (1, 300, 64, 32, "long_runs"),
    (4, 50, 32, 128, "repeat_across"),
    (6, 40, 1, 32, "scattered"),
    (700, 1, 8, 128, "long_runs"),       # n = 1, many streams (dedup)
    (9, 31, 64, 8, "long_runs"),         # n around a warp's 32 lanes
    (9, 32, 64, 8, "long_runs"),
    (9, 33, 64, 8, "long_runs"),
    (5, 257, 64, 16, "long_runs"),
    (4, 120, 8, 16, "split"),            # segments split two or three times
    (3, 257, 64, 5, "split"),
    (5, 64, 1 << 20, 16, "one_block"),   # runs break at each stream's edge
    (6, 33, 8, 128, "repeat_across"),
])
def test_plan_counts_ref_vs_planner(rng, p, n, block, c, kind):
    """The ``probe_plan_counts`` kernel's plain version: the reference
    planner's run count and the numpy min and max of the stream, as a
    (3,) int64 tensor, for (P, n) and (B, η, n) streams."""
    rows = _probe_stream(rng, p, n, block, kind, c)
    want = j_probe_ops.plan_probe_runs(rows, block_bits=block,
                                       probes_per_run=c)
    if kind == "split":
        assert (want.run_lengths == c).sum() >= want.n_runs // 3
    if kind == "one_block":
        assert want.n_runs == p * -(-n // c)
    for stream in (rows, rows.reshape(1, p, n)):
        got = probe_kernel.plan_counts(torch.from_numpy(stream), block, c)
        assert got.dtype == torch.int64 and got.shape == (3,)
        assert got.tolist() == [want.n_runs, rows.min(), rows.max()]
        assert torch.equal(got, probe_ref.plan_counts_ref(
            torch.from_numpy(stream), block, c))


def test_plan_counts_rejects_operands():
    """An empty stream, int32 probes and sizes below 1 raise, on either
    version's path; negative probes floor to their block as the planner's
    ``//`` does (blocks -3, -2, -1, 0, 0, 1)."""
    good = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    for rows, block, c in ((good[:0], 4, 8), (good.to(torch.int32), 4, 8),
                           (good, 0, 8), (good, 4, 0),
                           (torch.tensor(5), 4, 8)):
        with pytest.raises(ValueError):
            probe_kernel.plan_counts(rows, block, c)
    rows = np.array([[-9, -8, -1, 0, 3, 4]])
    want = j_probe_ops.plan_probe_runs(rows, block_bits=4, probes_per_run=8)
    assert probe_kernel.plan_counts(torch.from_numpy(rows), 4, 8).tolist() \
        == [want.n_runs, -9, 4] == [5, -9, 4]    # truncation would give 3


def test_compact_probe_plan_empty():
    for rows in (torch.empty((4, 0), dtype=torch.int64),
                 torch.empty((0, 3, 5), dtype=torch.int64)):
        plan = probe_ops.compact_probe_plan(rows, 64)
        assert (plan.n_runs, plan.n_probes, plan.min_row, plan.max_row) == \
            (0, 0, None, None)
        assert plan.run_lengths().shape == (0,)
    out = probe_kernel.gather_planned_rows(
        torch.zeros((8, 2), dtype=torch.int32),
        probe_ops.compact_probe_plan(torch.empty((0, 3, 5),
                                                 dtype=torch.int64), 4))
    assert out.shape == (0, 5, 2)


def _reference_and(words, rows, *, bit_probe, locs=None):
    """The reference's probe_rows (interpret mode) over the (B, eta, n_k)
    rows' run plan, then its own AND over eta (``_finish_probe``)."""
    b, eta, n_k = rows.shape
    jplan = j_probe_ops.plan_probe_runs(rows.reshape(b * eta, n_k),
                                        block_bits=8, probes_per_run=16)
    gathered = j_probe_ops.gather_planned_rows(jnp.asarray(words), jplan,
                                               interpret=True)
    gathered = gathered.reshape(b, eta, n_k, words.shape[1])
    return np.asarray(j_query._finish_probe(
        gathered, jnp.asarray(locs if bit_probe else rows),
        bit_probe=bit_probe))


@pytest.mark.parametrize("w", [1, 2, 32])
@pytest.mark.parametrize("eta", [1, 3, 4])
def test_gather_and_ref_vs_reference(rng, w, eta):
    """The row kernel's plain version (what a CPU matrix runs, through the
    wrapper and a compact plan) against the reference's Pallas gather in
    interpret mode followed by its AND over eta; rows with bit 31 set."""
    words = _words(rng, 256, w)
    words[:, 0] |= np.uint32(1 << 31)
    rows = rng.integers(0, 256, size=(3, eta, 23))
    rows[1] = np.sort(rng.integers(0, 24, size=(eta, 23)), axis=1)
    rows[2, :, 0] = 255                               # the last row
    want = _reference_and(words, rows, bit_probe=False)
    assert want.shape == (3, 23, w)
    got = probe_ref.gather_and_ref(_tw(words), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    before = probe_kernel.launches
    plan = probe_ops.compact_probe_plan(torch.from_numpy(rows), 8, 16)
    got = probe_kernel.gather_planned_rows(_tw(words), plan)
    assert probe_kernel.launches == before            # CPU: no launch
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (want[..., 0] >> 31).all()


@pytest.mark.parametrize("w", [1, 2, 32])
@pytest.mark.parametrize("eta", [1, 3, 4])
def test_probe_bits_and_ref_vs_reference(rng, w, eta):
    """The bit kernel's plain version against the reference's row gather in
    interpret mode followed by its bit extraction and AND over eta, and on
    the flat filter (W = 1) against its probe_runs Pallas kernel (interpret
    mode) and its jnp probe oracle; locations on bit 31 included."""
    n_rows = 256
    words = _words(rng, n_rows, w)
    words[rng.random(words.shape) < 0.6] = 0xFFFFFFFF    # many hits
    locs = rng.integers(0, 32 * n_rows, size=(3, eta, 23))
    locs[:, :, ::4] |= 31                                # bit 31
    want = _reference_and(words, locs >> 5, bit_probe=True,
                          locs=locs.astype(np.uint32))
    assert 0 < want.sum() < want.size
    got = probe_ref.probe_bits_and_ref(_tw(words), torch.from_numpy(locs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    before = probe_kernel.bits_launches
    plan = probe_ops.compact_probe_plan(torch.from_numpy(locs), 8 * 32, 16)
    np.testing.assert_array_equal(
        probe_kernel.probe_planned_bits(_tw(words), plan).numpy(), want)
    assert probe_kernel.bits_launches == before
    if w == 1:
        flat = words.reshape(-1)
        for b in range(3):
            jplan = j_probe_ops.plan_probe_runs(locs[b], block_bits=256,
                                                probes_per_run=16)
            for kw in (dict(interpret=True), dict(use_ref=True)):
                member = np.asarray(j_probe_ops.probe_membership(
                    jnp.asarray(flat), jplan, **kw))
                np.testing.assert_array_equal(want[b, :, 0] == 1, member)
        np.testing.assert_array_equal(
            probe_ref.probe_bits_and_ref(_tw(flat), torch.from_numpy(locs)),
            want[..., 0])
        np.testing.assert_array_equal(
            probe_ref.query_membership_ref(_tw(flat),
                                           torch.from_numpy(locs[0])),
            want[0, :, 0] == 1)


@pytest.mark.parametrize("bad", [-1, "past"])
def test_probe_kernels_reject_rows_outside(rng, bad):
    """A row past the matrix, or a negative one, raises before anything
    runs, from a compact plan or a bare tensor; so do a wrong rank and a
    wrong dtype."""
    matrix = _tw(_words(rng, 64, 2))
    rows = rng.integers(0, 64, size=(2, 3, 10))
    rows[1, 2, 7] = -1 if bad == -1 else 64
    for operand in (torch.from_numpy(rows),
                    probe_ops.compact_probe_plan(torch.from_numpy(rows), 8)):
        with pytest.raises(ValueError):
            probe_kernel.gather_planned_rows(matrix, operand)
    locs = rows * 32 + (-1 if bad == -1 else 0)
    for operand in (torch.from_numpy(locs),
                    probe_ops.compact_probe_plan(torch.from_numpy(locs), 256)):
        with pytest.raises(ValueError):
            probe_kernel.probe_planned_bits(matrix[:, 0].contiguous(),
                                            operand)
    good = torch.from_numpy(rows.clip(0, 63))
    with pytest.raises(ValueError):                  # rows of one dim
        probe_kernel.gather_planned_rows(matrix, good.reshape(-1))
    with pytest.raises(ValueError):                  # int32 rows
        probe_kernel.gather_planned_rows(matrix, good.to(torch.int32))
    with pytest.raises(ValueError):                  # a 1-D matrix
        probe_kernel.gather_planned_rows(matrix.reshape(-1), good)


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


# -- RAMBO's fused merge and coverage count --------------------------------

def rambo_answers(rng, n_reads, n_k, n_rep, n_buckets, n_files):
    """Answers ``(n_reads, n_k, R·B)`` int32 {0, 1} as the bit probe gives
    them, each bucket hit with a chance whose R-fold AND is 0.8 (the
    coverage θ 0.8 asks), every answer of one file's R buckets set in each
    read; and an (R, N) int32 assignment that leaves no bucket empty."""
    ans = rng.random((n_reads, n_k, n_rep * n_buckets)) < 0.8 ** (1 / n_rep)
    assign = np.stack([rng.permutation(np.arange(n_files) % n_buckets)
                       for _ in range(n_rep)]).astype(np.int32)
    cols = np.arange(n_rep) * n_buckets + assign[:, rng.integers(
        0, n_files, size=n_reads)].T                       # (n_reads, R)
    ans[np.arange(n_reads)[:, None], :, cols] = True
    return torch.from_numpy(ans.astype(np.int32)), torch.from_numpy(assign)


@pytest.mark.parametrize("mode", ["theta", "need", "padded"])
@pytest.mark.parametrize("theta", [1.0, 0.8])
@pytest.mark.parametrize("n_k", [1, 200, 231])
@pytest.mark.parametrize("n_rep", [2, 10])
@pytest.mark.parametrize("n_buckets", [32, 20, 40])
def test_rambo_merge_coverage_plain_vs_chain(n_buckets, n_rep, n_k, theta,
                                             mode):
    """The fused merge's plain version (what a CPU tensor runs, through the
    wrapper) against the chain it replaces, bit for bit: R gathers of the
    bucket columns and their AND (``RamboIndex.query_batch``), then the
    port's and the reference's ``member_coverage``. One or two words of
    buckets, a scalar need from theta, a per-row need, and valid masks with
    padded kmers and pad rows that replay row 0."""
    rng = np.random.default_rng(n_buckets * 1000 + n_rep * 100 + n_k)
    n_reads, n_files = 6, 3 * n_buckets + 7
    ans, assign = rambo_answers(rng, n_reads, n_k, n_rep, n_buckets,
                                n_files)
    valid = need = None
    if mode == "need":
        need = torch.from_numpy(rng.integers(
            n_k * 7 // 10, n_k + 2, size=n_reads, dtype=np.int32))
    elif mode == "padded":
        lengths = rng.integers(1, n_k + 1, size=n_reads)
        lengths[-2:] = lengths[0]                   # pad rows replay row 0
        ans[-2:] = ans[0]
        valid = torch.from_numpy(np.arange(n_k) < lengths[:, None])
        need = torch.from_numpy(
            t_query.coverage_need(theta, lengths).astype(np.int32))
    grid = (ans == 1).reshape(n_reads, n_k, n_rep, n_buckets)
    member = grid[:, :, 0, assign[0].long()]
    for r in range(1, n_rep):
        member &= grid[:, :, r, assign[r].long()]
    want = t_query.member_coverage(member, theta, valid=valid, need=need)
    ref_want = np.asarray(j_query.member_coverage(
        jnp.asarray(member.numpy()), theta,
        valid=None if valid is None else jnp.asarray(valid.numpy()),
        need=None if need is None else jnp.asarray(need.numpy())))
    np.testing.assert_array_equal(want.numpy(), ref_want)
    before = merge_kernel.launches
    got = merge_kernel.merge_coverage(
        ans, assign, t_query.coverage_need(theta, n_k) if need is None
        else need, valid)
    assert merge_kernel.launches == before              # CPU: no launch
    assert got.dtype == torch.bool and got.shape == (n_reads, n_files)
    assert torch.equal(got, want)
    if mode == "theta" and theta == 1.0 and n_k > 1:
        assert 0 < int(got.sum()) < got.numel()
