"""PyTorch port vs the JAX reference: the query and ingest layers, the
coverage reductions, the bit-sliced engine and its state. Matrices and
reads are made with numpy and handed to both packages; exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import idl as j_idl  # noqa: E402
from repro.index import engines as j_engines  # noqa: E402
from repro.index import ingest as j_ingest  # noqa: E402
from repro.index import packed as j_packed  # noqa: E402
from repro.index import query as j_query  # noqa: E402
from repro_torch.core import idl  # noqa: E402
from repro_torch.index import engines, ingest, packed, query  # noqa: E402
from repro_torch.index import state as state_mod  # noqa: E402
from repro_torch.kernels.idl_insert import kernel as ins_kernel  # noqa: E402
from repro_torch.kernels.idl_probe import kernel as probe_kernel  # noqa: E402

CFG = dict(k=31, t=12, L=1 << 10, eta=2, m=1 << 16)


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return j_idl.IDLConfig(**kw), idl.IDLConfig(**kw)


def _u32(t: "torch.Tensor") -> np.ndarray:
    return t.numpy().view(np.uint32)


def _words(rng, n_rows, w, density=0.9):
    words = rng.integers(0, 2 ** 32, size=(n_rows, w), dtype=np.uint64
                         ).astype(np.uint32)
    words[rng.random(words.shape) > density] = 0xFFFFFFFF
    return words


# -- plans -------------------------------------------------------------------

@pytest.mark.parametrize("bit_probe", [False, True])
@pytest.mark.parametrize("w", [1, 4])
def test_plan_query_defaults_match_reference(bit_probe, w):
    jc, tc = _cfgs(L=1 << 12)
    shape = (jc.m // 32, 1) if bit_probe else (jc.m, w)
    jp = j_query.plan_query(jc, "idl", (8, 100), shape, bit_probe=bit_probe)
    tp = query.plan_query(tc, "idl", (8, 100), shape, bit_probe=bit_probe,
                          device="cpu")
    assert (tp.rows_per_block, tp.probes_per_run, tp.block_bytes,
            tp.lane32) == \
        (jp.rows_per_block, jp.probes_per_run, jp.block_bytes, jp.lane32)
    assert tp.lane32 is False       # the reference's 64-bit hash path
    kind = "bits" if bit_probe else "cols"
    ji = j_ingest.plan_insert(jc, "idl", (8, 100), shape, kind=kind)
    ti = ingest.plan_insert(tc, "idl", (8, 100), shape, kind=kind,
                            device="cpu")
    assert (ti.lane32, ti.rows_per_block) == (ji.lane32, ji.rows_per_block)
    reads = np.random.default_rng(w).integers(0, 4, size=(3, 60),
                                              dtype=np.uint8)
    want = np.asarray(j_packed.batch_locations(jc, jnp.asarray(reads), "idl"))
    got = packed.batch_locations(tc, torch.from_numpy(reads), "idl")
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    accel = query.plan_query(tc, "idl", (8, 100), shape, bit_probe=bit_probe,
                             device="cuda")
    assert accel.probes_per_run == 128


def test_plan_query_full_config_tile_is_512_rows():
    tc = idl.IDLConfig(k=31, t=16, L=1 << 17, eta=4, m=1 << 26)
    p = query.plan_query(tc, "idl", (256, 230), (tc.m, 32), bit_probe=False)
    ip = ingest.plan_insert(tc, "idl", (512, 230), (tc.m, 32), kind="cols")
    assert p.rows_per_block == ip.rows_per_block == 512
    assert p.block_bytes == 64 * 1024


@pytest.mark.parametrize("scheme", ["idl", "rh"])
def test_query_plan_runs_match_reference(rng, scheme):
    jc, tc = _cfgs()
    reads = rng.integers(0, 4, size=(6, 120), dtype=np.uint8)
    shape = (jc.m, 2)
    jp = j_query.plan_query(jc, scheme, reads.shape, shape, bit_probe=False,
                            lane32=True, probes_per_run=32)
    tp = query.plan_query(tc, scheme, reads.shape, shape, bit_probe=False,
                          lane32=True, device="cpu")
    jr, jlocs = jp.plan_runs(jnp.asarray(reads))
    tr, tlocs = tp.plan_runs(torch.from_numpy(reads))
    np.testing.assert_array_equal(tlocs.numpy(), jlocs.astype(np.int64))
    for f in ("block_ids", "offsets", "run_lengths", "probe_index",
              "gather_index", "n_probes", "eta", "n_keys"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f))
    assert tp.run_dma_bytes(tr) == jp.run_dma_bytes(jr)


@pytest.mark.parametrize("scheme", ["idl", "rh"])
@pytest.mark.parametrize("bit_probe,w", [(False, 2), (True, 1)])
def test_query_compact_plan_matches_reference_plan(rng, scheme, bit_probe, w):
    """The serve path's compact plan (row indices, or bit locations planned
    in blocks of 32 x rows_per_block bits) has the reference planner's run
    count, probe count, run lengths and tile bytes."""
    jc, tc = _cfgs()
    reads = rng.integers(0, 4, size=(6, 120), dtype=np.uint8)
    shape = (jc.m // 32, 1) if bit_probe else (jc.m, w)
    jp = j_query.plan_query(jc, scheme, reads.shape, shape,
                            bit_probe=bit_probe, lane32=True,
                            probes_per_run=32)
    tp = query.plan_query(tc, scheme, reads.shape, shape, bit_probe=bit_probe,
                          lane32=True, device="cpu")
    jr, jlocs = jp.plan_runs(jnp.asarray(reads))
    cplan = tp.compact_plan(torch.from_numpy(reads))
    np.testing.assert_array_equal(cplan.rows.numpy(), jlocs.astype(np.int64))
    assert cplan.rows.shape == (6, jc.eta, 120 - jc.k + 1)
    assert (cplan.n_runs, cplan.n_probes) == (jr.n_runs, jr.n_probes)
    np.testing.assert_array_equal(cplan.run_lengths(), jr.run_lengths)
    assert tp.run_dma_bytes(cplan) == jp.run_dma_bytes(jr) > 0


# -- query execution ---------------------------------------------------------

@pytest.mark.parametrize("scheme", ["idl", "rh"])
@pytest.mark.parametrize("bit_probe,w", [(False, 1), (False, 3), (True, 1),
                                         (True, 4)])
@pytest.mark.parametrize("backend", ["torch", "idl_probe"])
def test_query_execute_matches_reference(rng, scheme, bit_probe, w, backend):
    jc, tc = _cfgs()
    n_rows = jc.m // 32 if bit_probe else jc.m
    words = _words(rng, n_rows, w)
    reads = rng.integers(0, 4, size=(5, 90), dtype=np.uint8)
    jp = j_query.plan_query(jc, scheme, reads.shape, words.shape,
                            bit_probe=bit_probe, lane32=True)
    tp = query.plan_query(tc, scheme, reads.shape, words.shape,
                          bit_probe=bit_probe, lane32=True, device="cpu")
    want = np.asarray(jp.execute(jnp.asarray(words), jnp.asarray(reads),
                                 backend="jnp"))
    before = probe_kernel.launches
    got = tp.execute(torch.from_numpy(words.view(np.int32).copy()), reads,
                     backend=backend)
    assert probe_kernel.launches == before
    assert got.shape == want.shape
    np.testing.assert_array_equal(_u32(got), want)


def test_query_unknown_backend_raises():
    _, tc = _cfgs()
    tp = query.plan_query(tc, "idl", (1, 40), (tc.m, 1), bit_probe=False,
                          device="cpu")
    with pytest.raises(ValueError):
        tp.execute(torch.zeros((tc.m, 1), dtype=torch.int32),
                   np.zeros((1, 40), np.uint8), backend="jnp")


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 100])
def test_and_reduce_is_a_bitwise_and(rng, n):
    x = rng.integers(-2 ** 31, 2 ** 31, size=(3, n, 5)).astype(np.int32)
    want = np.bitwise_and.reduce(x, axis=1)
    np.testing.assert_array_equal(
        query.and_reduce(torch.from_numpy(x), dim=1).numpy(), want)


# -- coverage reductions -----------------------------------------------------

@pytest.mark.parametrize("theta", [1.0, 0.6, 0.25])
@pytest.mark.parametrize("padded", [False, True])
def test_file_match_mask_matches_reference(rng, theta, padded):
    b, n_k, w = 6, 40, 3
    per = _words(rng, b * n_k, w, density=0.5).reshape(b, n_k, w)
    per[:, :, 0] |= np.uint32(0x80000000)        # bit 31 always hits
    valid = need = None
    if padded:
        lens = rng.integers(1, n_k + 1, size=b)
        valid = np.arange(n_k)[None, :] < lens[:, None]
        need = np.array([j_query.coverage_need(theta, int(n)) for n in lens],
                        dtype=np.int32)
    jkw = {} if not padded else dict(valid=jnp.asarray(valid),
                                     need=jnp.asarray(need))
    tkw = {} if not padded else dict(valid=torch.from_numpy(valid),
                                     need=torch.from_numpy(need))
    want = np.asarray(j_query.file_match_mask(jnp.asarray(per), theta, **jkw))
    got = query.file_match_mask(torch.from_numpy(per.view(np.int32)), theta,
                                **tkw)
    np.testing.assert_array_equal(_u32(got), want)
    if padded:      # the masked-AND path at theta = 1 without need
        want = np.asarray(j_query.file_match_mask(
            jnp.asarray(per), 1.0, valid=jnp.asarray(valid)))
        got = query.file_match_mask(torch.from_numpy(per.view(np.int32)), 1.0,
                                    valid=torch.from_numpy(valid))
        np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("theta", [1.0, 0.6, 0.25])
def test_member_coverage_matches_reference(rng, theta):
    member = rng.random((5, 30, 4)) < 0.8
    lens = rng.integers(1, 31, size=5)
    valid = np.arange(30)[None, :] < lens[:, None]
    need = np.array([j_query.coverage_need(theta, int(n)) for n in lens],
                    dtype=np.int32)
    for kw in ({}, dict(valid=valid, need=need)):
        want = np.asarray(j_query.member_coverage(
            jnp.asarray(member), theta,
            **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = query.member_coverage(
            torch.from_numpy(member), theta,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("theta,n", [(1.0, 200), (0.6, 7), (0.25, 33),
                                     (0.5, 10), (0.1, 1)])
def test_coverage_need_matches_reference(theta, n):
    assert query.coverage_need(theta, n) == j_query.coverage_need(theta, n)


def test_unpack_file_bits(rng):
    masks = _words(rng, 4, 3)
    want = np.asarray(j_packed.unpack_file_bits(jnp.asarray(masks), 90))
    got = packed.unpack_file_bits(torch.from_numpy(masks.view(np.int32)), 90)
    np.testing.assert_array_equal(got.numpy(), want)


# -- ingest ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bits", "rows", "cols"])
@pytest.mark.parametrize("backend", ["torch", "idl_insert"])
@pytest.mark.parametrize("scheme", ["idl", "rh"])
def test_insert_execute_matches_reference(rng, kind, backend, scheme):
    jc, tc = _cfgs()
    reads = rng.integers(0, 4, size=(6, 80), dtype=np.uint8)
    if kind == "bits":
        shape, aux = (jc.m // 32, 1), None
    elif kind == "rows":
        shape, aux = (12, jc.m // 32), rng.integers(0, 12, size=(6, 2))
    else:
        shape, aux = (jc.m, 3), rng.integers(0, 96, size=6)
    words = _words(rng, *shape, density=0.3)
    words[:] = np.where(rng.random(shape) < 0.95, 0, words)
    jp = j_ingest.plan_insert(jc, scheme, reads.shape, shape, kind=kind,
                              lane32=True)
    tp = ingest.plan_insert(tc, scheme, reads.shape, shape, kind=kind,
                            lane32=True, device="cpu")
    jaux = None if aux is None else jnp.asarray(aux.astype(np.int32))
    want = np.asarray(jp.execute(jnp.asarray(words), jnp.asarray(reads), jaux,
                                 backend="jnp"))
    jr = jp.plan_runs(jnp.asarray(reads), jaux)
    tr = tp.plan_runs(torch.from_numpy(reads),
                      None if aux is None else torch.from_numpy(aux))
    np.testing.assert_array_equal(tr.offsets, jr.offsets)
    np.testing.assert_array_equal(tr.block_ids, jr.block_ids)
    assert tp.run_dma_bytes(tr) == jp.run_dma_bytes(jr)
    mat = torch.from_numpy(words.view(np.int32).copy())
    before = ins_kernel.launches
    got = tp.execute(mat, reads, aux, backend=backend)
    assert ins_kernel.launches == before
    assert got.data_ptr() == mat.data_ptr()          # in place
    np.testing.assert_array_equal(_u32(got), want)


def test_insert_donate_false_keeps_input(rng):
    _, tc = _cfgs()
    tp = ingest.plan_insert(tc, "idl", (2, 60), (tc.m, 1), kind="cols",
                            device="cpu")
    mat = torch.zeros((tc.m, 1), dtype=torch.int32)
    reads = rng.integers(0, 4, size=(2, 60), dtype=np.uint8)
    out = tp.execute(mat, reads, np.array([0, 5]), donate=False)
    assert int(mat.count_nonzero()) == 0 and int(out.count_nonzero()) > 0


@pytest.mark.parametrize("op", ["query", "insert"])
def test_planned_backends_record_locality_and_stage_times(rng, op,
                                                          monkeypatch):
    from repro.obs import metrics as j_metrics
    from repro_torch.obs import metrics as t_metrics

    jc, tc = _cfgs()
    reads = rng.integers(0, 4, size=(4, 90), dtype=np.uint8)
    shape = (jc.m, 2)
    words = _words(rng, *shape, density=0.3)
    mat = torch.from_numpy(words.view(np.int32).copy())
    j_metrics.reset()
    # a registry of its own: no series another test bound in this process
    monkeypatch.setattr(t_metrics, "DEFAULT", t_metrics.Registry())
    monkeypatch.setattr(query, "_STAGE_TIMERS", {})
    monkeypatch.setattr(query, "_LOCALITY_HANDLES", {})
    if op == "query":
        jp = j_query.plan_query(jc, "idl", reads.shape, shape,
                                bit_probe=False, lane32=True)
        tp = query.plan_query(tc, "idl", reads.shape, shape, bit_probe=False,
                              lane32=True, device="cpu")
        jp.execute(jnp.asarray(words), jnp.asarray(reads),
                   backend="idl_probe", use_ref=True)
        tp.execute(mat, reads, backend="idl_probe")
    else:
        fids = rng.integers(0, 64, size=4)
        jp = j_ingest.plan_insert(jc, "idl", reads.shape, shape, kind="cols",
                                  lane32=True)
        tp = ingest.plan_insert(tc, "idl", reads.shape, shape, kind="cols",
                                lane32=True, device="cpu")
        jp.execute(jnp.asarray(words), jnp.asarray(reads),
                   jnp.asarray(fids.astype(np.int32)), backend="idl_insert",
                   use_ref=True)
        tp.execute(mat, reads, fids, backend="idl_insert")
    j_snap, t_snap = j_metrics.DEFAULT.snapshot(), t_metrics.DEFAULT.snapshot()
    where = {"scheme": "idl", "op": op}
    for name in ("locality.planned_tile_bytes", "locality.probe_runs",
                 "locality.probes", "locality.batches"):
        want = j_metrics.counter_total(j_snap, name, where)
        assert want > 0
        assert t_metrics.counter_total(t_snap, name, where) == want
    stages = {t_metrics.parse_label_key(lk)["stage"]: h for lk, h in
              t_snap["hists"]["planner.stage_ms"].items()
              if t_metrics.parse_label_key(lk)["op"] == op}
    assert sorted(stages) == ["device_plan", "launch", "locations"]
    assert all(h["count"] == 1 and h["sum"] >= 0 for h in stages.values())


@pytest.mark.parametrize("op", ["query", "insert"])
def test_planned_batches_read_no_run_lengths(rng, monkeypatch, op):
    """The serve and insert paths count their plans' runs (``locality.*``)
    without building run lengths, and keep no run-length or batch-wall
    histogram."""
    from repro_torch.obs import metrics as t_metrics
    from repro_torch.serving import service

    def refuse(self):
        raise AssertionError("run_lengths() called on the main path")

    monkeypatch.setattr(probe_kernel.CompactProbePlan, "run_lengths", refuse)
    monkeypatch.setattr(ins_kernel.CompactInsertPlan, "run_lengths", refuse)
    _, tc = _cfgs()
    eng = engines.BitSlicedIndex.build(tc, "idl", 64, device="cpu")
    eng = eng.insert_batch(rng.integers(0, 4, size=(8, 90), dtype=np.uint8),
                           np.arange(8), backend="idl_insert")
    svc = service.GeneSearchService(eng, service.ServiceConfig(max_batch=4))
    where = {"scheme": "idl", "op": op}
    before = t_metrics.counter_total(t_metrics.DEFAULT.snapshot(),
                                     "locality.batches", where)
    for i in range(8):
        reads = rng.integers(0, 4, size=(4, 90), dtype=np.uint8)
        if op == "query":
            svc.search(list(reads))
        else:
            eng = eng.insert_batch(reads, (np.arange(4) + 4 * i) % 64,
                                   backend="idl_insert")
    snap = t_metrics.DEFAULT.snapshot()
    assert t_metrics.counter_total(snap, "locality.batches",
                                   where) == before + 8
    assert "locality.run_length" not in snap["hists"]
    assert "serving.batch_wall_ms" not in snap["hists"]


def test_scatter_or_matrix_drops_out_of_range_and_duplicates():
    mat = torch.zeros((4, 2), dtype=torch.int32)
    rows = torch.tensor([0, 0, 3, 4, -1, 3])
    cols = torch.tensor([1, 1, 0, 0, 0, 0])
    bits = torch.tensor([31, 31, 2, 5, 5, 2])
    packed.scatter_or_matrix(mat, rows, cols, bits)
    want = np.zeros((4, 2), np.uint32)
    want[0, 1] = 1 << 31
    want[3, 0] = 4
    np.testing.assert_array_equal(_u32(mat), want)


# -- the bit-sliced engine and its state -------------------------------------

@pytest.mark.parametrize("scheme", ["idl", "rh"])
def test_bitsliced_engine_matches_reference(rng, scheme):
    jc, tc = _cfgs()
    jeng = j_engines.BitSlicedIndex.build(jc, scheme, 64)
    teng = engines.BitSlicedIndex.build(tc, scheme, 64, device="cpu")
    for rnd in range(3):
        reads = rng.integers(0, 4, size=(8, 100), dtype=np.uint8)
        fids = rng.integers(0, 64, size=8).astype(np.int32)
        jeng = jeng.insert_batch(jnp.asarray(reads), fids)
        teng = teng.insert_batch(
            reads, torch.from_numpy(fids) if rnd == 2 else fids,
            backend=("idl_insert", "torch")[rnd % 2])
        np.testing.assert_array_equal(_u32(teng.words), np.asarray(jeng.words))
    queries = np.concatenate(
        [reads[:4], rng.integers(0, 4, size=(4, 100), dtype=np.uint8)])
    for theta in (1.0, 0.6, 0.25):
        want = np.asarray(jeng.msmt(jnp.asarray(queries), theta=theta))
        for backend in ("idl_probe", "torch"):
            got = teng.msmt(queries, theta=theta, backend=backend)
            np.testing.assert_array_equal(got.numpy(), want)
    assert teng.msmt(queries[:4]).numpy()[np.arange(4), fids[:4]].all()


def test_consumed_engine_raises_and_donate_false_keeps_it(rng):
    _, tc = _cfgs()
    eng = engines.BitSlicedIndex.build(tc, "idl", 32, device="cpu")
    reads = rng.integers(0, 4, size=(2, 60), dtype=np.uint8)
    kept = eng.insert_batch(reads, [0, 1], donate=False)
    assert int(eng.words.count_nonzero()) == 0      # input untouched
    new = eng.insert_batch(reads, [0, 1])
    assert torch.equal(new.words, kept.words)
    with pytest.raises(state_mod.StaleIndexError):
        eng.query_batch(reads)
    with pytest.raises(state_mod.StaleIndexError):
        eng.insert_batch(reads, [0, 1])
    st = new.state
    st2 = state_mod.insert(st, reads, [2, 3])
    with pytest.raises(state_mod.StaleIndexError):
        state_mod.query(st, reads)
    hits = state_mod.msmt(st2, reads).numpy()
    assert hits[0, [0, 2]].all() and hits[1, [1, 3]].all()
    with pytest.raises(ValueError):
        new.insert_batch(reads, [0])                 # file ids != batch
    for bad in ([0, 32], [-1, 0]):                   # outside [0, n_files)
        with pytest.raises(ValueError):
            new.insert_batch(reads, bad)
