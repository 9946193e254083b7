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
    empty = torch.empty((0, 16), dtype=torch.int32)
    ins_ref.insert_planned_ref(mat, empty[:, 0], empty, rows_per_block=4)
    np.testing.assert_array_equal(mat.numpy().view(np.uint32), words)
    flat = rng.integers(0, 256 * 32, size=300)
    plan = ins_ops.plan_insert_runs(flat, block_bits=128, inserts_per_run=16)
    flat_words = _tw(words).reshape(-1)                  # W == 1 as 1-D
    ins_ops.insert_planned(flat_words, plan)
    want = np.asarray(j_ins_ops.insert_planned(
        jnp.asarray(words), plan, use_ref=True))
    np.testing.assert_array_equal(flat_words.numpy().view(np.uint32),
                                  want.reshape(-1))
