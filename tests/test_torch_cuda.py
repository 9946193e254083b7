"""CUDA kernels of the PyTorch port against their plain versions, on a card.

Every test here needs a CUDA device and skips without one (the ``cuda``
marker selects them: ``python -m pytest -m cuda tests/test_torch_*.py``).
Comparisons are exact: the kernels move and OR integer bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import idl, minhash  # noqa: E402
from repro_torch.index import engines  # noqa: E402
from repro_torch.kernels.idl_insert import kernel as ins_kernel  # noqa: E402
from repro_torch.kernels.idl_insert import ops as ins_ops  # noqa: E402
from repro_torch.kernels.idl_insert import ref as ins_ref  # noqa: E402
from repro_torch.kernels.idl_probe import kernel as probe_kernel  # noqa: E402
from repro_torch.kernels.idl_probe import ops as probe_ops  # noqa: E402
from repro_torch.kernels.idl_probe import ref as probe_ref  # noqa: E402
from repro_torch.kernels.window_min import kernel as wm_kernel  # noqa: E402
from repro_torch.kernels.window_min import ref as wm_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _matrix(rng, n_rows, w, device):
    m = rng.integers(-2 ** 31, 2 ** 31, size=(n_rows, w), dtype=np.int64)
    return torch.as_tensor(m.astype(np.int32), device=device)


@pytest.mark.parametrize("w", [1, 2, 3, 4, 32, 33, 64, 160])
@pytest.mark.parametrize("eta", [1, 3, 4])
def test_gather_planned_rows_kernel_vs_plain(cuda, w, eta):
    """The row kernel's AND over eta on every lane layout (16-byte units in
    groups of 1, 8 or 16 lanes, or looped; 4-byte words in groups, or
    looped), ragged n_k, a row at the matrix's last row; from a compact
    plan and from a bare tensor."""
    rng = np.random.default_rng(10 * w + eta)
    n_rows = 1 << 10
    matrix = _matrix(rng, n_rows, w, cuda)
    rows = rng.integers(0, n_rows, size=(5, eta, 37))
    rows[1] = np.sort(rng.integers(0, 64, size=(eta, 37)), axis=1)
    rows[2, :, 0] = n_rows - 1
    rows = torch.as_tensor(rows, device=cuda)
    plan = probe_ops.compact_probe_plan(rows, 64)
    before = probe_kernel.launches
    got = probe_kernel.gather_planned_rows(matrix, plan)
    bare = probe_kernel.gather_planned_rows(matrix, rows)
    torch.cuda.synchronize()
    assert probe_kernel.launches == before + 2
    want = probe_ref.gather_and_ref(matrix, rows)
    assert got.shape == (5, 37, w)
    assert torch.equal(got, want) and torch.equal(bare, want)
    assert torch.equal(got.cpu(), probe_ref.gather_and_ref(matrix.cpu(),
                                                           rows.cpu()))


def test_gather_planned_rows_misaligned_view(cuda):
    """A matrix view 4 bytes past a 16-byte boundary takes the 4-byte word
    path of the same kernel, and agrees with the plain version."""
    rng = np.random.default_rng(4)
    n_rows, w = 512, 32
    base = _matrix(rng, n_rows * w + 1, 1, cuda).reshape(-1)
    matrix = base[1:].view(n_rows, w)
    assert matrix.is_contiguous() and matrix.data_ptr() % 16 == 4
    rows = torch.as_tensor(rng.integers(0, n_rows, size=(3, 4, 50)),
                           device=cuda)
    before = probe_kernel.launches
    got = probe_kernel.gather_planned_rows(matrix, rows)
    torch.cuda.synchronize()
    assert probe_kernel.launches == before + 1
    assert torch.equal(got, probe_ref.gather_and_ref(matrix, rows))


@pytest.mark.parametrize("n_rows,w,rpb,c", [
    (256, 3, 16, 32), (1 << 12, 1, 64, 128), (512, 8, 8, 64),
    (1 << 10, 32, 64, 128), (1 << 10, 33, 32, 40),
])
def test_gather_planned_rows_run_plan(cuda, n_rows, w, rpb, c):
    """A run plan (the reference's layout, pad lanes and all) through its
    rows put back into probe order: one launch, the rows in probe order."""
    rng = np.random.default_rng(n_rows + w)
    matrix = _matrix(rng, n_rows, w, cuda)
    rows = rng.integers(0, n_rows, size=(3, 97))
    rows[1].sort()                       # long runs beside scattered ones
    rows[2] = np.sort(rng.integers(0, 3 * rpb, size=97))   # runs of ~32
    plan = probe_ops.plan_probe_runs(rows, block_bits=rpb, probes_per_run=c)
    assert (plan.offsets < 0).any()      # pad lanes present
    before = probe_kernel.launches
    got = probe_ops.gather_planned_rows(matrix, plan)
    torch.cuda.synchronize()
    assert probe_kernel.launches == before + 1
    assert np.array_equal(got.cpu().numpy(),
                          matrix.cpu().numpy()[rows.reshape(-1)])


def test_probe_kernels_empty_batch_no_launch(cuda):
    """B = 0 (and n_k = 0) make no launch and return empty answers."""
    matrix = torch.zeros((64, 32), dtype=torch.int32, device=cuda)
    words = torch.zeros((64,), dtype=torch.int32, device=cuda)
    before = (probe_kernel.launches, probe_kernel.bits_launches)
    for shape in ((0, 4, 200), (3, 4, 0)):
        rows = torch.zeros(shape, dtype=torch.int64, device=cuda)
        plan = probe_ops.compact_probe_plan(rows, 8)
        assert plan.n_runs == 0 and plan.max_row is None
        out = probe_kernel.gather_planned_rows(matrix, plan)
        assert out.shape == (shape[0], shape[2], 32)
        bits = probe_kernel.probe_planned_bits(words, plan)
        assert bits.shape == (shape[0], shape[2])
    torch.cuda.synchronize()
    assert (probe_kernel.launches, probe_kernel.bits_launches) == before


@pytest.mark.parametrize("n_rows,w,rpb,c,n_bits", [
    (256, 3, 16, 32, 900), (1 << 12, 1, 64, 128, 3000),
    (1 << 10, 32, 64, 128, 20000), (512, 8, 8, 40, 777),
])
def test_insert_planned_kernel_vs_plain(cuda, n_rows, w, rpb, c, n_bits):
    rng = np.random.default_rng(n_bits)
    matrix = _matrix(rng, n_rows, w, cuda)
    flat = rng.integers(0, n_rows * w * 32, size=n_bits)
    flat[:50] = -1                       # masked targets are dropped
    plan = ins_ops.plan_insert_runs(flat, block_bits=rpb * w * 32,
                                    inserts_per_run=c)
    want = ins_ref.insert_planned_ref(matrix.clone(),
                                      torch.as_tensor(flat, device=cuda))
    before = ins_kernel.launches
    got = ins_ops.insert_planned(matrix, plan)
    torch.cuda.synchronize()
    assert ins_kernel.launches == before + 1
    assert got.data_ptr() == matrix.data_ptr()       # in place
    assert torch.equal(got, want)


def test_empty_insert_plan_is_identity(cuda):
    matrix = torch.arange(64, dtype=torch.int32, device=cuda).reshape(16, 4)
    before = ins_kernel.launches
    assert ins_ops.insert_planned(matrix, None) is matrix
    ins_kernel.insert_planned(matrix, torch.empty(0, dtype=torch.int64,
                                                  device=cuda))
    assert ins_ops.insert_planned(matrix, ins_ops.compact_insert_plan(
        torch.full((5,), -1, device=cuda), 64)) is matrix
    torch.cuda.synchronize()
    assert ins_kernel.launches == before
    assert torch.equal(matrix.cpu(), torch.arange(64, dtype=torch.int32)
                       .reshape(16, 4))


@pytest.mark.parametrize("w,sort", [(1, True), (32, True), (32, False),
                                    (3, False)])
def test_insert_positions_kernel_vs_plain(cuda, w, sort):
    """The compact operand: sorted unique positions (the main path's), or
    unsorted with duplicates, several bits of one word, and masked ones."""
    rng = np.random.default_rng(w)
    matrix = _matrix(rng, 1 << 10, w, cuda)
    flat = np.concatenate([rng.integers(0, matrix.numel() * 32, size=20000),
                           np.arange(640, 700), np.repeat([77, 78], 40),
                           [-1, -(1 << 40)]])
    if sort:
        operand = ins_ops.compact_insert_plan(
            torch.as_tensor(flat, device=cuda), 64 * w * 32)
        positions = operand.positions
        assert operand.n_locs == np.unique(flat[flat >= 0]).size
    else:
        rng.shuffle(flat)
        positions = operand = torch.as_tensor(flat, device=cuda)
    want = ins_ref.insert_planned_ref(matrix.cpu(), positions.cpu())
    before = ins_kernel.launches
    got = ins_kernel.insert_planned(matrix, operand)
    torch.cuda.synchronize()
    assert ins_kernel.launches == before + 1
    assert got is matrix
    assert torch.equal(got.cpu(), want)


def test_kernels_reject_bad_operands(cuda):
    matrix = torch.zeros((64, 2), dtype=torch.int32, device=cuda)
    offs = torch.zeros((1, 32), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):                  # int32 positions
        ins_kernel.insert_planned(matrix, offs.to(torch.int32).reshape(-1))
    with pytest.raises(ValueError):                  # past the last word
        ins_kernel.insert_planned(matrix, torch.tensor([64 * 2 * 32],
                                                       device=cuda))
    rows = torch.zeros((1, 2, 3), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):                  # rows on the host
        probe_kernel.gather_planned_rows(matrix, rows.cpu())
    with pytest.raises(ValueError):                  # int32 rows
        probe_kernel.gather_planned_rows(matrix, rows.to(torch.int32))
    with pytest.raises(ValueError):                  # past the last row
        probe_kernel.gather_planned_rows(matrix, rows + 64)
    with pytest.raises(ValueError):                  # not contiguous
        probe_kernel.gather_planned_rows(matrix, rows.transpose(1, 2))
    with pytest.raises(ValueError):                  # an int64 filter
        probe_kernel.probe_planned_bits(matrix.to(torch.int64), rows)
    with pytest.raises(ValueError):                  # past the last bit
        probe_kernel.probe_planned_bits(matrix, rows + 64 * 2 * 32)


def test_engine_backends_agree_on_cuda(cuda):
    cfg = idl.IDLConfig(k=31, t=12, L=1 << 10, eta=2, m=1 << 18)
    rng = np.random.default_rng(5)
    planned = engines.BitSlicedIndex.build(cfg, "idl", 64, device=cuda)
    plain = engines.BitSlicedIndex.build(cfg, "idl", 64, device=cuda)
    for _ in range(3):
        reads = rng.integers(0, 4, size=(32, 100), dtype=np.uint8)
        fids = rng.integers(0, 64, size=32)
        planned = planned.insert_batch(reads, fids, backend="idl_insert")
        plain = plain.insert_batch(reads, fids, backend="torch")
    assert torch.equal(planned.words, plain.words)
    queries = np.concatenate(
        [reads[:8], rng.integers(0, 4, size=(8, 100), dtype=np.uint8)])
    before = probe_kernel.launches
    a = planned.query_batch(queries, backend="idl_probe")
    assert probe_kernel.launches == before + 1       # one launch per batch
    b = planned.query_batch(queries, backend="torch")
    assert torch.equal(a, b)
    assert planned.msmt(queries[:8]).cpu().numpy()[
        np.arange(8), fids[:8]].all()


def _window_input(rng, shape, dtype, device):
    if dtype == torch.float32:
        a = rng.normal(size=shape).astype(np.float32)
    elif dtype == torch.int32:
        a = rng.integers(-2 ** 31, 2 ** 31, size=shape).astype(np.int32)
    else:
        a = rng.integers(-2 ** 63, 2 ** 63 - 1, size=shape, dtype=np.int64)
    return torch.as_tensor(a, device=device)


@pytest.mark.parametrize("dtype", ["int64", "int32", "float32"])
@pytest.mark.parametrize("shape,w", [
    ((1000,), 1), ((3, 700), 2), ((256, 215), 16), ((5, 200), 31),
    ((2, 255), 16), ((1, 3000), 1024), ((4, 31), 31),
])
def test_window_min_kernel_vs_plain(cuda, dtype, shape, w):
    dtype = getattr(torch, dtype)
    a = _window_input(np.random.default_rng(w), shape, dtype, cuda)
    before = wm_kernel.launches
    got = wm_kernel.window_min(a, w)
    torch.cuda.synchronize()
    assert wm_kernel.launches == before + 1
    assert torch.equal(got, wm_ref.window_min_ref(a, w=w))
    assert torch.equal(got, wm_ref.window_min_naive(a, w=w))


def test_window_min_kernel_unsigned_order_and_errors(cuda):
    rng = np.random.default_rng(3)
    h = torch.as_tensor(rng.integers(-2 ** 63, 2 ** 63 - 1, size=(8, 215),
                                     dtype=np.int64), device=cuda)
    h[h % 3 == 0] = minhash.UINT64_MAX
    flipped = h ^ minhash.SIGN
    got = minhash.sliding_window_min(flipped, 16) ^ minhash.SIGN
    want = wm_ref.window_min_ref(flipped.cpu(), w=16) ^ minhash.SIGN
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError):
        wm_kernel.window_min(torch.zeros((2, 2000), device=cuda), 1025)
    with pytest.raises(ValueError):
        wm_kernel.window_min(torch.zeros((2, 20), dtype=torch.int16,
                                         device=cuda), 4)
    with pytest.raises(ValueError):
        wm_kernel.window_min(torch.zeros((20, 2), dtype=torch.int64,
                                         device=cuda).t(), 4)


@pytest.mark.parametrize("form", ["doph_lanes64", "doph_u64", "exact_u64",
                                  "exact_i32", "exact_f32"])
@pytest.mark.parametrize("shape,w", [((3, 215), 16), ((2, 700), 1),
                                     ((4, 300), 31), ((1, 40), 40)])
def test_window_min_one_launch_per_minhash(cuda, form, shape, w):
    """Both fused forms and the unsigned order, on the card, against the
    plain version (the stack of masks and the Gil–Werman minimum); the DOPH
    hashes leave bin 3 of 4 empty."""
    rng = np.random.default_rng(w)
    eta = 4
    if form.endswith("u64"):
        a = _window_input(rng, shape, torch.int64, cuda)
        fill, unsigned, shift = minhash.UINT64_MAX, True, 32
    elif form.endswith("lanes64"):
        a = torch.as_tensor(rng.integers(0, 1 << 32, size=shape), device=cuda)
        fill, unsigned, shift = minhash.FILL32, False, 16
    elif form.endswith("i32"):
        a = _window_input(rng, shape, torch.int32, cuda)
        fill, unsigned, shift = None, False, None
    else:
        a = _window_input(rng, shape, torch.float32, cuda)
        fill, unsigned, shift = None, False, None
    kw = dict(unsigned=unsigned)
    if form.startswith("exact"):
        a = torch.stack([a, a.flip(-1), a * 3, -a], dim=-2)
    else:
        top2 = 2 * shift - 2                      # bins of 4: the top bits
        a = torch.where(wm_ref.doph_bins(a, eta, shift) == 3,
                        a ^ (1 << top2), a)       # bin 3 -> 2
        assert (wm_ref.doph_bins(a, eta, shift) != 3).all()
        kw.update(n_bins=eta, bin_shift=shift, fill=fill)
    before = wm_kernel.launches
    got = wm_kernel.window_min(a, w, **kw)
    torch.cuda.synchronize()
    assert wm_kernel.launches == before + 1
    want = wm_ref.window_min_binned_ref(a, w=w, **kw)
    assert got.shape == want.shape == shape[:-1] + (eta, shape[-1] - w + 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,L,c", [(1 << 20, 1 << 12, 128),
                                   (1 << 18, 1 << 10, 64),
                                   (1 << 22, 1 << 15, 128)])
def test_probe_planned_bits_kernel_vs_plain(cuda, m, L, c):
    """probe_membership of a run plan (its lanes back in probe order) and
    of the compact plan of the same locations: one launch each, equal to
    each other and to the direct oracle."""
    rng = np.random.default_rng(m)
    words = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, size=m // 32)
                            .astype(np.int32), device=cuda)
    locs = rng.integers(0, m, size=(4, 900))
    locs[1] = np.sort(locs[1])                       # long runs
    locs[2] = np.sort(rng.integers(0, 3 * L, size=900))
    plan = probe_ops.plan_probe_runs(locs, block_bits=L, probes_per_run=c)
    assert (plan.offsets < 0).any()
    tlocs = torch.as_tensor(locs, device=cuda)
    cplan = probe_ops.compact_probe_plan(tlocs, L, c)
    assert (cplan.n_runs, cplan.n_probes) == (plan.n_runs, plan.n_probes)
    assert np.array_equal(cplan.run_lengths(), plan.run_lengths)
    before = probe_kernel.bits_launches
    got = probe_ops.probe_membership(words, plan)
    compact = probe_ops.probe_membership(words, cplan)
    bits = probe_kernel.probe_planned_bits(words, tlocs)
    torch.cuda.synchronize()
    assert probe_kernel.bits_launches == before + 3
    assert torch.equal(bits, probe_ref.probe_bits_and_ref(words, tlocs))
    direct = probe_ref.query_membership_ref(words, tlocs)
    assert torch.equal(got, direct) and torch.equal(compact, direct)
    assert torch.equal(bits == 1, direct)


@pytest.mark.parametrize("w", [1, 2, 32])
@pytest.mark.parametrize("eta", [1, 3, 4])
def test_probe_planned_bits_widths(cuda, w, eta):
    """The bit kernel on (B, eta, n_k) locations over a 1-D filter (W = 1)
    or an (n_rows, W) matrix, ragged n_k, bit 31 and the last bit
    included, against the plain version."""
    rng = np.random.default_rng(100 * w + eta)
    n_rows = 1 << 12
    matrix = _matrix(rng, n_rows, w, cuda)
    matrix[torch.as_tensor(rng.random((n_rows, w)) < 0.7, device=cuda)] = -1
    words = matrix.reshape(-1) if w == 1 else matrix
    locs = rng.integers(0, 32 * n_rows, size=(6, eta, 41))
    locs[:, :, ::3] |= 31
    locs[5, :, 0] = 32 * n_rows - 1
    locs = torch.as_tensor(locs, device=cuda)
    before = probe_kernel.bits_launches
    got = probe_kernel.probe_planned_bits(
        words, probe_ops.compact_probe_plan(locs, 32 * 64))
    torch.cuda.synchronize()
    assert probe_kernel.bits_launches == before + 1
    want = probe_ref.probe_bits_and_ref(words, locs)
    assert got.shape == ((6, 41) if w == 1 else (6, 41, w))
    assert torch.equal(got, want) and 0 < int(want.sum()) < want.numel()


@pytest.mark.parametrize("m,L,c", [(1 << 20, 1 << 12, 128),
                                   (1 << 18, 1 << 10, 32)])
def test_insert_with_plan_kernel_vs_plain(cuda, m, L, c):
    rng = np.random.default_rng(L)
    locs = rng.integers(0, m, size=(4, 3000))
    locs[0, :400] = rng.integers(0, L, size=400)     # one block, many rounds
    plan = ins_ops.plan_insert_rounds(locs, block_bits=L,
                                      inserts_per_round=c)
    assert len(plan.rounds) > 2
    words = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, size=m // 32)
                            .astype(np.int32), device=cuda)
    want = ins_ops.insert_with_plan(words.cpu(), plan)
    before = ins_kernel.round_launches
    got = ins_ops.insert_with_plan(words, plan)
    torch.cuda.synchronize()
    assert ins_kernel.round_launches == before + 1   # all rounds, one launch
    assert got is words
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("scheme", ["idl", "rh"])
def test_flat_filter_backends_agree_on_cuda(cuda, scheme):
    cfg = idl.IDLConfig(k=31, t=16, L=1 << 12, eta=4, m=1 << 22)
    rng = np.random.default_rng(9)
    planned = engines.PackedBloomIndex.build(cfg, scheme, device=cuda)
    plain = engines.PackedBloomIndex.build(cfg, scheme, device=cuda)
    host = engines.PackedBloomIndex.build(cfg, scheme, device="cpu")
    for _ in range(2):
        reads = rng.integers(0, 4, size=(16, 230), dtype=np.uint8)
        planned = planned.insert_batch(reads, backend="idl_insert")
        plain = plain.insert_batch(reads, backend="torch")
        host = host.insert_batch(reads, backend="torch")
    assert torch.equal(planned.words, plain.words)
    assert torch.equal(planned.words.cpu(), host.words)
    queries = np.concatenate(
        [reads[:8], rng.integers(0, 4, size=(8, 230), dtype=np.uint8)])
    before = probe_kernel.bits_launches, probe_kernel.launches
    a = planned.query_batch(queries, backend="idl_probe")
    # the flat filter's query plan launches only the bit kernel
    assert (probe_kernel.bits_launches, probe_kernel.launches) == \
        (before[0] + 1, before[1])
    assert torch.equal(a, planned.query_batch(queries, backend="torch"))
    assert torch.equal(a.cpu(), host.query_batch(queries))
    assert planned.msmt(queries[:8]).all()


# -- the gather's bit mode, and the engines that run it ----------------------

@pytest.mark.parametrize("w", [1, 8, 320])
@pytest.mark.parametrize("eta", [1, 3, 4])
def test_gather_planned_bits_kernel_vs_plain(cuda, w, eta):
    """The bit mode's AND over eta of shifted words at the flat width, a
    width whose units form lane groups and RAMBO's 320 words (looped
    units); ragged n_k, locations at the matrix's last bit; from a compact
    plan and from a bare tensor."""
    rng = np.random.default_rng(100 * w + eta)
    n_rows = 1 << 10
    matrix = _matrix(rng, n_rows, w, cuda)
    locs = rng.integers(0, 32 * n_rows, size=(5, eta, 37))
    locs[1] = np.sort(rng.integers(0, 32 * 64, size=(eta, 37)), axis=1)
    locs[2, :, 0] = 32 * n_rows - 1
    locs[3, :, ::3] |= 31
    locs = torch.as_tensor(locs, device=cuda)
    plan = probe_ops.compact_probe_plan(locs, 32 * 64)
    before = probe_kernel.bit_mode_launches
    got = probe_kernel.gather_planned_bits(matrix, plan)
    bare = probe_kernel.gather_planned_bits(matrix, locs)
    torch.cuda.synchronize()
    assert probe_kernel.bit_mode_launches == before + 2
    want = probe_ref.gather_bits_and_ref(matrix, locs)
    assert got.shape == (5, 37, w) and 0 < int(want.sum()) < want.numel()
    assert torch.equal(got, want) and torch.equal(bare, want)
    assert torch.equal(got, probe_kernel.probe_planned_bits(matrix, plan))
    assert torch.equal(got.cpu(), probe_ref.gather_bits_and_ref(
        matrix.cpu(), locs.cpu()))


def test_gather_planned_bits_misaligned_view_empty_batch_and_bounds(cuda):
    """A 320-word matrix view 4 bytes past a 16-byte boundary (4-byte word
    path), an empty batch (no launch), a location past the last bit."""
    rng = np.random.default_rng(7)
    n_rows, w = 512, 320
    base = _matrix(rng, n_rows * w + 1, 1, cuda).reshape(-1)
    matrix = base[1:].view(n_rows, w)
    assert matrix.data_ptr() % 16 == 4
    locs = torch.as_tensor(rng.integers(0, 32 * n_rows, size=(3, 4, 50)),
                           device=cuda)
    got = probe_kernel.gather_planned_bits(matrix, locs)
    assert torch.equal(got, probe_ref.gather_bits_and_ref(matrix, locs))
    before = probe_kernel.bit_mode_launches
    for shape in ((0, 4, 200), (3, 4, 0)):
        out = probe_kernel.gather_planned_bits(
            matrix, torch.zeros(shape, dtype=torch.int64, device=cuda))
        assert out.shape == (shape[0], shape[2], w)
    torch.cuda.synchronize()
    assert probe_kernel.bit_mode_launches == before
    with pytest.raises(ValueError):
        probe_kernel.gather_planned_bits(matrix, locs + 32 * n_rows)


@pytest.mark.parametrize("kind", ["cobs", "rambo"])
def test_cobs_rambo_msmt_on_cuda(cuda, kind):
    """COBS and RAMBO on the card: inserts and queries through the kernels
    equal the plain backends and the CPU; one launch per query (per size
    group for COBS, of the bit mode for RAMBO); dedup changes nothing; a
    RAMBO query after an insert sees the new file."""
    cfg = idl.IDLConfig(k=31, t=16, L=1 << 10, eta=3, m=1 << 20)
    rng = np.random.default_rng(11)
    genomes = rng.integers(0, 4, size=(7, 400), dtype=np.uint8)
    sizes = [370, 120, 800, 240, 500, 310, 90]

    def build(device):
        if kind == "cobs":
            return engines.CobsIndex.build(sizes, cfg, n_groups=3,
                                           device=device)
        # R·B = 10 words a transposed row: the bit mode's route
        return engines.RamboIndex.build(7, cfg, B=5, R=2, device=device)

    engs = {}
    for name, device, backend in (("planned", cuda, "idl_insert"),
                                  ("plain", cuda, "torch"),
                                  ("cpu", "cpu", "idl_insert")):
        engs[name] = build(device).insert_batch(genomes[:6], np.arange(6),
                                                backend=backend)
    for a, b in zip(engs["planned"].state.words, engs["plain"].state.words):
        assert torch.equal(a, b)
    reads = np.concatenate([genomes[:, 30:260], rng.integers(
        0, 4, size=(3, 230), dtype=np.uint8)])
    counter = "launches" if kind == "cobs" else "bit_mode_launches"
    per_query = 3 if kind == "cobs" else 1
    before = getattr(probe_kernel, counter)
    got = engs["planned"].msmt(reads, theta=0.6)
    assert getattr(probe_kernel, counter) == before + per_query
    assert torch.equal(got, engs["planned"].msmt(reads, theta=0.6,
                                                 backend="torch"))
    assert torch.equal(got.cpu(), engs["cpu"].msmt(reads, theta=0.6))
    assert torch.equal(got, engs["planned"].msmt(reads, theta=0.6,
                                                 dedup=True))
    assert got.cpu().numpy()[np.arange(6), np.arange(6)].all()
    if kind == "rambo":
        assert not bool(got[6, 6])
        eng = engs["planned"].insert_batch(genomes[6:], [6])
        assert bool(eng.msmt(reads[6:7])[0, 6])


# -- the serving tier on the card ---------------------------------------------

def _tier_reads():
    rng = np.random.default_rng(21)
    genomes = rng.integers(0, 4, size=(6, 400), dtype=np.uint8)
    queries = [genomes[i % 6, s:s + n] for i, (s, n) in enumerate(
        [(10, 230), (40, 120), (90, 77), (0, 230), (200, 61), (150, 199),
         (5, 230), (60, 100)])]
    queries += list(rng.integers(0, 4, size=(2, 150), dtype=np.uint8))
    return genomes, queries


def _tier_engine(kind, device, genomes):
    cfg = idl.IDLConfig(k=31, t=16, L=1 << 10, eta=3, m=1 << 20)
    if kind == "rambo":
        eng = engines.RamboIndex.build(7, cfg, B=5, R=2, device=device)
    else:
        eng = engines.BitSlicedIndex.build(cfg, "idl", 40, device=device)
    return eng.insert_batch(genomes[:4], np.asarray([0, 3, 5, 6]))


def _tier_rows(results):
    return [r.matches for r in results]


@pytest.mark.parametrize("kind", ["bitsliced", "rambo"])
def test_cached_service_on_cuda(cuda, kind):
    """The membership cache over a CUDA index: its misses are probed by
    the kernels (the dedup path), two passes equal the plain ``"torch"``
    backend, and the warm pass is all hits."""
    from repro_torch.serving import (GeneSearchService, KmerCacheConfig,
                                     ServiceConfig)

    genomes, queries = _tier_reads()
    eng = _tier_engine(kind, cuda, genomes)
    plain = GeneSearchService(eng, ServiceConfig(backend="torch",
                                                 max_batch=4))
    cached = GeneSearchService(eng, ServiceConfig(
        backend="idl_probe", max_batch=4,
        kmer_cache=KmerCacheConfig(1 << 14)))
    counter = "launches" if kind == "bitsliced" else "bit_mode_launches"
    before = getattr(probe_kernel, counter)
    want = _tier_rows(plain.search(queries))
    cold = _tier_rows(cached.search(queries))
    assert getattr(probe_kernel, counter) > before
    s1 = cached.cache_stats()
    warm = _tier_rows(cached.search(queries))
    s2 = cached.cache_stats()
    for a, b, c in zip(want, cold, warm):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    # pass two: every lookup hits, nothing more is probed
    assert s2["lookups"] - s1["lookups"] == s2["hits"] - s1["hits"] > 0
    assert s2["misses"] == s1["misses"]


def test_two_replica_router_on_cuda(cuda):
    """Two replicas on one card share the index's tensors and answer like
    the plain backend."""
    from repro_torch.serving import (GeneSearchService, ReplicaRouter,
                                     RouterConfig, ServiceConfig)

    genomes, queries = _tier_reads()
    eng = _tier_engine("bitsliced", cuda, genomes)
    want = _tier_rows(GeneSearchService(eng, ServiceConfig(
        backend="torch", max_batch=4)).search(queries))
    with ReplicaRouter(eng, ServiceConfig(max_batch=4),
                       RouterConfig(n_replicas=2,
                                    policy="round_robin")) as rt:
        assert all(r.service.state.words[0] is eng.words
                   for r in rt._replicas)
        futures = [rt.submit(q) for q in queries * 2]
        got = _tier_rows(f.result(timeout=60) for f in futures)
        for a, b in zip(want * 2, got):
            np.testing.assert_array_equal(a, b)
        assert {s.replica for s in rt.cluster_stats()} == {0, 1}


def test_live_router_insert_and_compaction_on_cuda(cuda):
    """A live router on the card: a fanned write becomes visible on both
    replicas, a compaction publishes one merged base to both, and every
    answer equals the plain backend over a union index."""
    from repro_torch.serving import (GeneSearchService, LiveReplicaRouter,
                                     RouterConfig, ServiceConfig)

    genomes, queries = _tier_reads()
    base = _tier_engine("bitsliced", cuda, genomes)
    union = base.insert_batch(genomes[4:6], np.asarray([20, 39]),
                              donate=False)
    want = _tier_rows(GeneSearchService(union, ServiceConfig(
        backend="torch", max_batch=4)).search(queries))
    base_words = base.words.clone()
    with LiveReplicaRouter(base, ServiceConfig(max_batch=4),
                           RouterConfig(n_replicas=2,
                                        policy="round_robin")) as rt:
        before = ins_kernel.launches
        acks = [f.result(timeout=60) for f in
                rt.insert(genomes[4:6], np.asarray([20, 39]))]
        assert {a.delta_seq for a in acks} == {1}
        assert ins_kernel.launches == before + 2     # one per replica
        for phase in ("delta", "compacted"):
            got = _tier_rows(f.result(timeout=60) for f in
                             [rt.submit(q) for q in queries * 2])
            for a, b in zip(want * 2, got):
                np.testing.assert_array_equal(a, b)
            if phase == "delta":
                assert rt.compact() == 1
        lives = [r.service.live for r in rt._replicas]
        assert lives[0].base is lives[1].base
        assert torch.equal(base.words, base_words)   # never written


def _fleet_launches(stats) -> dict:
    """Kernel launches summed over a fleet's ``stats`` replies."""
    out: dict = {}
    for s in stats.values():
        for name, n in s["device"]["launches"].items():
            out[name] = out.get(name, 0) + n
    return out


def test_two_worker_fabric_on_cuda(cuda, tmp_path):
    """Two worker processes each load the snapshot onto the card: answers
    equal the direct service before and after a fanned write, each worker
    launched the kernels (its stats reply's counters) and reports its peak
    device memory."""
    from repro_torch.index import store
    from repro_torch.serving import (FabricConfig, GeneSearchService,
                                     ProcessFabric, ServiceConfig)

    genomes, queries = _tier_reads()
    base = _tier_engine("bitsliced", cuda, genomes)
    union = base.insert_batch(genomes[4:6], np.asarray([20, 39]),
                              donate=False)
    svc_cfg = ServiceConfig(max_batch=4)
    want = [_tier_rows(GeneSearchService(e, svc_cfg).search(queries))
            for e in (base, union)]
    snap = store.save(base, str(tmp_path / "snap"))
    with ProcessFabric(snap, FabricConfig(n_workers=2, device="cuda",
                                          service=svc_cfg),
                       journal_path=str(tmp_path / "wal.idlj")) as fab:
        for rows, phase in zip(want, ("base", "union")):
            if phase == "union":
                fab.insert(genomes[4:6], [20, 39]).result(timeout=120)
            got = _tier_rows(f.result(timeout=120) for f in
                             [fab.submit(q) for q in queries * 2])
            for a, b in zip(rows * 2, got):
                assert isinstance(b, np.ndarray)
                np.testing.assert_array_equal(a, b)
        stats = fab.stats()
        launches = _fleet_launches(stats)
        assert launches["gather_planned_rows"] > 0
        assert launches["window_min"] > 0
        assert launches["insert_planned"] == 2        # one per worker
        assert all(s["device"]["max_memory_allocated"] > 0
                   for s in stats.values())


def test_two_shard_scatter_router_on_cuda(cuda, tmp_path):
    """An in-process scatter router over two file shards loaded onto the
    card answers like the direct service over the unsharded index, each
    shard's slice served through the row kernel."""
    from repro_torch.index import shards
    from repro_torch.serving import (GeneSearchService, ScatterConfig,
                                     ScatterGatherRouter, ServiceConfig)

    genomes, queries = _tier_reads()
    cfg = idl.IDLConfig(k=31, t=16, L=1 << 10, eta=3, m=1 << 20)
    eng = engines.BitSlicedIndex.build(cfg, "idl", 70, device=cuda
                                       ).insert_batch(
        genomes, np.asarray([0, 3, 33, 40, 64, 69]))
    svc_cfg = ServiceConfig(max_batch=4)
    want = _tier_rows(GeneSearchService(eng, svc_cfg).search(queries))
    spec, parts = shards.partition_state(eng, 2)
    set_dir = shards.save_shard_set(spec, parts, str(tmp_path / "set"))
    before = probe_kernel.launches
    with ScatterGatherRouter(set_dir, ScatterConfig(
            service=svc_cfg, device="cuda")) as router:
        got = [f.result(timeout=120) for f in
               [router.submit(q) for q in queries]]
    assert probe_kernel.launches > before
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b.matches)
        assert b.missing_files == ()
