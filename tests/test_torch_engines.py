"""PyTorch port vs the JAX reference: the COBS and RAMBO engines, minimizer
ingest, the query dedup path and the plan caches, state and snapshots of
the new engines, the service and the deprecated adapters over them, and the
plain version of the gather's bit mode. Inputs are made with numpy and
handed to both packages; every comparison is exact."""

import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import cobs as j_cobs  # noqa: E402
from repro.core import idl as j_idl  # noqa: E402
from repro.core import rambo as j_rambo  # noqa: E402
from repro.index import engines as j_engines  # noqa: E402
from repro.index import ingest as j_ingest  # noqa: E402
from repro.index import packed as j_packed  # noqa: E402
from repro.index import query as j_query  # noqa: E402
from repro.index import store as j_store  # noqa: E402
from repro.kernels.idl_probe import ops as j_probe_ops  # noqa: E402
from repro.obs import metrics as j_metrics  # noqa: E402
from repro.serving import service as j_service  # noqa: E402
from repro_torch.core import cobs, idl, rambo  # noqa: E402
from repro_torch.index import GeneIndex, engines, ingest, query  # noqa: E402
from repro_torch.index import state as state_mod, store  # noqa: E402
from repro_torch.kernels.idl_probe import kernel as probe_kernel  # noqa: E402
from repro_torch.kernels.idl_probe import ops as probe_ops  # noqa: E402
from repro_torch.kernels.idl_probe import ref as probe_ref  # noqa: E402
from repro_torch.obs import metrics as t_metrics  # noqa: E402
from repro_torch.serving import service  # noqa: E402

# the small sizes of the reference's own engine parity tests
CFG = dict(k=31, t=16, L=1 << 10, eta=3, m=1 << 20)
COBS_SIZES = [370, 120, 800, 240, 500, 310]
N_RAMBO, N_BUCKETS, N_REP = 7, 3, 2


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return j_idl.IDLConfig(**kw), idl.IDLConfig(**kw)


def _u32(t: "torch.Tensor") -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _genomes(kind: str) -> np.ndarray:
    n = len(COBS_SIZES) if kind == "cobs" else N_RAMBO
    return np.random.default_rng(1 if kind == "cobs" else 2).integers(
        0, 4, size=(n, 400), dtype=np.uint8)


def _empty(kind: str, scheme: str):
    """A fresh (reference, port) engine pair of ``kind``."""
    jc, tc = _cfgs()
    if kind == "cobs":
        return (j_engines.CobsIndex.build(COBS_SIZES, jc, scheme=scheme,
                                          n_groups=3),
                engines.CobsIndex.build(COBS_SIZES, tc, scheme=scheme,
                                        n_groups=3, device="cpu"))
    return (j_engines.RamboIndex.build(N_RAMBO, jc, scheme=scheme,
                                       B=N_BUCKETS, R=N_REP),
            engines.RamboIndex.build(N_RAMBO, tc, scheme=scheme, B=N_BUCKETS,
                                     R=N_REP, device="cpu"))


@functools.lru_cache(maxsize=None)
def _built(kind: str, scheme: str, window_min):
    """Every genome inserted under its file id: the reference (jnp backend)
    and the port through each insert backend."""
    g = _genomes(kind)
    fids = np.arange(len(g))
    jeng, _ = _empty(kind, scheme)
    jeng = jeng.insert_batch(jnp.asarray(g), fids, window_min=window_min)
    ports = {}
    for backend in ingest.BACKENDS:
        _, teng = _empty(kind, scheme)
        ports[backend] = teng.insert_batch(g, fids, backend=backend,
                                           window_min=window_min)
    return jeng, ports


def _queries(kind: str) -> np.ndarray:
    """230-base reads of every indexed genome, and random reads."""
    g = _genomes(kind)
    rng = np.random.default_rng(3)
    reads = [g[i, s:s + 230] for i in range(len(g))
             for s in rng.integers(0, 170, size=2)]
    reads += list(rng.integers(0, 4, size=(3, 230), dtype=np.uint8))
    return np.stack(reads)


def _state_words(eng) -> list:
    return [np.asarray(w).view(np.uint32) if not isinstance(w, torch.Tensor)
            else _u32(w) for w in eng.state.words]


# -- the engines -------------------------------------------------------------

@pytest.mark.parametrize("window_min", [None, 8])
@pytest.mark.parametrize("scheme", ["idl", "rh"])
@pytest.mark.parametrize("kind", ["cobs", "rambo"])
def test_engine_words_after_insert(kind, scheme, window_min):
    jeng, ports = _built(kind, scheme, window_min)
    want = _state_words(jeng)
    for backend, teng in ports.items():
        got = _state_words(teng)
        assert len(got) == len(want) == (3 if kind == "cobs" else 1)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=backend)
    if window_min is not None:          # sub-sampling: a subset of the bits
        full = _state_words(_built(kind, scheme, None)[0])
        for sub, whole in zip(want, full):
            assert ((sub & ~whole) == 0).all()
        assert sum(int(np.unpackbits(w.view(np.uint8)).sum())
                   for w in want) < sum(
            int(np.unpackbits(w.view(np.uint8)).sum()) for w in full)


@pytest.mark.parametrize("window_min", [None, 8])
@pytest.mark.parametrize("theta", [1.0, 0.6])
@pytest.mark.parametrize("scheme", ["idl", "rh"])
@pytest.mark.parametrize("kind", ["cobs", "rambo"])
def test_engine_queries_match_reference(kind, scheme, theta, window_min):
    jeng, ports = _built(kind, scheme, window_min)
    reads = _queries(kind)
    jr = jnp.asarray(reads)
    want_q = np.asarray(jeng.query_batch(jr))
    want_m = np.asarray(jeng.msmt(jr, theta=theta))
    teng = ports["idl_insert"]
    for backend in query.BACKENDS:
        got = teng.query_batch(reads, backend=backend)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want_q)
        np.testing.assert_array_equal(
            teng.msmt(reads, theta=theta, backend=backend).numpy(), want_m)
        if kind == "rambo":
            np.testing.assert_array_equal(
                teng.query_grid(reads, backend=backend).numpy(),
                np.asarray(jeng.query_grid(jr)))
    if window_min is None:              # every indexed read is found
        own = np.repeat(np.arange(len(_genomes(kind))), 2)
        assert want_m[np.arange(own.size), own].all()
    assert teng.total_bits == jeng.total_bits


@pytest.mark.parametrize("n_files", [1, 2, 7, 100, 1024, 1500])
def test_rambo_dimensions_and_assignment(n_files):
    assert engines.rambo_dimensions(n_files) == \
        j_engines.rambo_dimensions(n_files)
    assert engines.rambo_dimensions(n_files, 5, 3) == (5, 3)
    b, r = engines.rambo_dimensions(n_files)
    got = engines.rambo_assignment(n_files, b, r)
    assert got.dtype == np.int32 and got.shape == (r, n_files)
    np.testing.assert_array_equal(got,
                                  j_engines.rambo_assignment(n_files, b, r))


def test_full_rambo_shape_is_32_buckets_by_10():
    tc = idl.IDLConfig(k=31, t=16, L=1 << 17, eta=4, m=1 << 25)
    eng = engines.RamboIndex.build(1024, tc, device="meta")
    assert (eng.n_buckets, eng.n_rep) == (32, 10)
    assert tuple(eng.words.shape) == (320, 1 << 20)


def test_cobs_build_matches_reference_grouping():
    jc, tc = _cfgs(L=1 << 12)
    sizes = np.random.default_rng(4).integers(100, 50_000, size=77)
    jeng = j_engines.CobsIndex.build(sizes, jc, n_groups=4)
    teng = engines.CobsIndex.build(sizes, tc, n_groups=4, device="meta")
    assert [(g.cfg.m, g.file_ids, tuple(g.words.shape)) for g in teng.groups] \
        == [(g.cfg.m, g.file_ids, tuple(g.words.shape)) for g in jeng.groups]
    assert teng.total_bits == jeng.total_bits
    assert teng._slot(int(sizes.argmax())) == jeng._slot(int(sizes.argmax()))
    with pytest.raises(ValueError):
        engines.CobsIndex.build([], tc)
    with pytest.raises(KeyError):
        teng._slot(77)


def test_engine_file_ids_are_checked():
    for kind in ("cobs", "rambo"):
        _, teng = _empty(kind, "idl")
        reads = _genomes(kind)[:2, :100]
        for fids in (None, [0], [0, 99], [-1, 0]):
            with pytest.raises(ValueError):
                teng.insert_batch(reads, fids)


@pytest.mark.parametrize("kind", ["cobs", "rambo"])
def test_consumed_engine_raises_and_donate_false_keeps_it(kind):
    _, teng = _empty(kind, "idl")
    g = _genomes(kind)
    kept = teng.insert_batch(g[:2], [0, 1], donate=False)
    assert not teng.query_batch(g[:1, :100]).any()     # the input is unchanged
    assert kept.query_batch(g[:1, :100])[0, :, 0].all()
    # the new value shares no storage with the old one
    later = kept.insert_batch(g[2:3], [2])
    assert not teng.query_batch(g[2:3, :100]).any()
    assert later.query_batch(g[2:3, :100])[0, :, 2].all()
    with pytest.raises(state_mod.StaleIndexError):
        kept.query_batch(g[:1, :100])


def test_rambo_query_insert_query_sees_the_new_file():
    """The transposed copy the queries probe is kept on the words tensor;
    an in-place insert drops it, so a query after the insert sees the new
    file (the reference rebuilds its copy per index value)."""
    g = _genomes("rambo")
    reads = g[:, 50:280]
    jeng, teng = _empty("rambo", "idl")
    jeng = jeng.insert_batch(jnp.asarray(g[:-1]), np.arange(N_RAMBO - 1))
    teng = teng.insert_batch(g[:-1], np.arange(N_RAMBO - 1))
    before = teng.msmt(reads)
    np.testing.assert_array_equal(before.numpy(),
                                  np.asarray(jeng.msmt(jnp.asarray(reads))))
    assert not bool(before[-1, -1])
    words_t = teng._words_t
    assert teng._words_t is words_t and words_t.is_contiguous()
    teng = teng.insert_batch(g[-1:], [N_RAMBO - 1])
    jeng = jeng.insert_batch(jnp.asarray(g[-1:]), np.asarray([N_RAMBO - 1]))
    assert teng._words_t is not words_t
    after = teng.msmt(reads)
    np.testing.assert_array_equal(after.numpy(),
                                  np.asarray(jeng.msmt(jnp.asarray(reads))))
    assert bool(after[-1, -1])
    for backend in query.BACKENDS:
        np.testing.assert_array_equal(
            teng.query_grid(reads, backend=backend).numpy(),
            np.asarray(jeng.query_grid(jnp.asarray(reads))))


def _rambo_obs():
    """``{"merge": n, "transpose": n}`` query stage samples and ``(copies,
    bytes)`` transposed copies the port's registry holds so far."""
    snap = t_metrics.DEFAULT.snapshot()
    stages = {"merge": 0, "transpose": 0}
    for lk, h in snap["hists"].get("planner.stage_ms", {}).items():
        labels = t_metrics.parse_label_key(lk)
        if labels.get("op") == "query" and labels["stage"] in stages:
            stages[labels["stage"]] += h["count"]
    where = {"engine": "rambo"}
    return stages, tuple(t_metrics.counter_total(snap, name, where)
                         for name in ("index.transposed_copies",
                                      "index.transposed_bytes"))


def _rambo_merges():
    """``{path: n}`` merged batches in ``index.rambo_merges`` so far."""
    snap = t_metrics.DEFAULT.snapshot()
    return {p: t_metrics.counter_total(snap, "index.rambo_merges",
                                       {"path": p})
            for p in ("fused", "per_kmer")}


@pytest.mark.parametrize("backend", query.BACKENDS)
def test_rambo_query_batch_records_one_merge_a_call(backend):
    """``query_batch`` (the per-kmer merge) and ``coverage_batch`` (the
    fused merge and count; ``msmt`` goes through it) each time one
    ``merge`` stage a call and count it under their path; the fused
    verdicts equal ``member_coverage`` over ``query_batch``'s hits."""
    g = _genomes("rambo")
    teng = _built("rambo", "idl", None)[1]["idl_insert"]
    reads = g[:, 20:250]
    for n_calls in (1, 2, 3):
        before, _ = _rambo_obs()
        merges = _rambo_merges()
        for _ in range(n_calls):
            teng.query_batch(reads, backend=backend)
        after, _ = _rambo_obs()
        assert after["merge"] - before["merge"] == n_calls
        assert _rambo_merges() == {"fused": merges["fused"],
                                   "per_kmer": merges["per_kmer"] + n_calls}
        for _ in range(n_calls):
            teng.coverage_batch(reads, 0.8, backend=backend)
        fused, _ = _rambo_obs()
        assert fused["merge"] - after["merge"] == n_calls
        assert _rambo_merges()["fused"] == merges["fused"] + n_calls
    want = query.member_coverage(teng.query_batch(reads, backend=backend),
                                 0.8)
    assert torch.equal(teng.coverage_batch(reads, 0.8, backend=backend), want)
    assert torch.equal(teng.msmt(reads, 0.8, backend=backend), want)


def test_transposed_copy_counted_once_per_words_tensor():
    """One copy a words tensor, counted with its bytes and its transpose
    stage; none on a second query; one more after an insert drops it."""
    g = _genomes("rambo")
    reads = g[:, 50:280]
    _, teng = _empty("rambo", "idl")
    teng = teng.insert_batch(g[:-1], np.arange(N_RAMBO - 1))
    nbytes = teng.words.nbytes
    stages0, (copies0, bytes0) = _rambo_obs()
    teng.msmt(reads)
    stages1, (copies1, bytes1) = _rambo_obs()
    assert (copies1 - copies0, bytes1 - bytes0) == (1, nbytes)
    assert stages1["transpose"] - stages0["transpose"] == 1
    teng.msmt(reads)
    teng.query_batch(reads)
    stages2, (copies2, bytes2) = _rambo_obs()
    assert (copies2, bytes2) == (copies1, bytes1)
    assert stages2["transpose"] == stages1["transpose"]
    teng = teng.insert_batch(g[-1:], [N_RAMBO - 1])
    _, (copies3, _) = _rambo_obs()
    assert copies3 == copies2
    teng.msmt(reads)
    stages4, (copies4, bytes4) = _rambo_obs()
    assert (copies4 - copies3, bytes4 - bytes2) == (1, nbytes)
    assert stages4["transpose"] - stages2["transpose"] == 1


def test_bitsliced_query_records_no_merge_or_transpose():
    _, tc = _cfgs()
    g = _genomes("rambo")
    eng = engines.BitSlicedIndex.build(tc, n_files=N_RAMBO, device="cpu")
    eng = eng.insert_batch(g, np.arange(N_RAMBO))
    before = _rambo_obs()
    svc = service.GeneSearchService(eng, service.ServiceConfig(max_batch=4))
    svc.search(g[:, 20:250])
    for backend in query.BACKENDS:
        eng.msmt(g[:, 20:250], backend=backend)
    assert _rambo_obs() == before


def test_every_engine_is_a_gene_index():
    jc, tc = _cfgs()
    bloom = engines.PackedBloomIndex.build(tc, device="cpu")
    sliced = engines.BitSlicedIndex.build(tc, n_files=40, device="cpu")
    for eng in (bloom, sliced, *(_empty(k, "idl")[1]
                                 for k in ("cobs", "rambo"))):
        assert isinstance(eng, GeneIndex)
        assert type(eng.with_state(eng.state)) is type(eng)
    with pytest.raises(ValueError):
        bloom.with_state(sliced.state)
    assert not isinstance(object(), GeneIndex)


# -- the verdict rule --------------------------------------------------------

# each read's kmer count in the padded case: 200, 150 and 90 of 200 slots
VERDICT_READ_LENS = (230, 180, 120)


@functools.lru_cache(maxsize=None)
def _verdict_engines(kind: str):
    """A (reference, port) pair of ``kind``, every genome inserted under
    its file id (the flat filter, one set, only the first three)."""
    if kind in ("cobs", "rambo"):
        jeng, ports = _built(kind, "idl", None)
        return jeng, ports["idl_insert"]
    jc, tc = _cfgs()
    g = _genomes("rambo")
    if kind == "bloom":
        g = g[:3]
        jeng = j_engines.PackedBloomIndex.build(jc)
        teng = engines.PackedBloomIndex.build(tc, device="cpu")
    else:
        jeng = j_engines.BitSlicedIndex.build(jc, n_files=len(g))
        teng = engines.BitSlicedIndex.build(tc, n_files=len(g), device="cpu")
    fids = np.arange(len(g))
    return (jeng.insert_batch(jnp.asarray(g), fids),
            teng.insert_batch(g, fids))


def _verdict_reads(kind: str) -> np.ndarray:
    """``_queries``' 230-base reads, the 0, 4, 12 or 40 bases before base
    50 replaced by random ones in turn: kmer coverage on both sides of 0.8
    in every prefix the padded case keeps."""
    reads = _queries("cobs" if kind == "cobs" else "rambo").copy()
    rng = np.random.default_rng(8)
    for i, n in enumerate(np.resize([0, 4, 12, 40], len(reads))):
        reads[i, 50 - n:50] = rng.integers(0, 4, size=n, dtype=np.uint8)
    return reads


@functools.lru_cache(maxsize=None)
def _reference_msmt(kind: str, theta: float, read_len: int) -> np.ndarray:
    """The reference's ``msmt`` of every verdict read cut to ``read_len``."""
    reads = _verdict_reads(kind)[:, :read_len]
    want = np.asarray(_verdict_engines(kind)[0].msmt(jnp.asarray(reads),
                                                     theta=theta))
    # the port's flat filter answers as an index of one file: (B, 1)
    return want[:, None] if kind == "bloom" else want


@pytest.mark.parametrize("padding", ["none", "pad_kmers"])
@pytest.mark.parametrize("theta", [1.0, 0.8])
@pytest.mark.parametrize("kind", ["bloom", "cobs", "bitsliced", "rambo"])
def test_coverage_batch_is_the_verdict_rule_on_query_batch(kind, theta,
                                                           padding):
    """Every engine's ``coverage_batch`` (and ``msmt``) equals the one
    verdict rule (``state.verdicts``) over its ``query_batch``, and the
    reference's ``msmt`` of the unpadded reads. Padded: reads of 200, 150
    and 90 kmers in one 230-base batch, the pad kmers masked by ``valid``
    and each row's threshold in ``need``."""
    teng = _verdict_engines(kind)[1]
    reads = _verdict_reads(kind)
    n_slots = reads.shape[1] - CFG["k"] + 1
    valid = need = None
    want = _reference_msmt(kind, theta, reads.shape[1])
    if padding == "pad_kmers":
        lens = np.resize(VERDICT_READ_LENS, len(reads))
        n_k = lens - CFG["k"] + 1
        # pad bases: another file's read, whose kmers would hit there
        reads, whole = reads.copy(), reads
        for i, n in enumerate(lens):
            reads[i, n:] = whole[(i + 2) % len(reads), :reads.shape[1] - n]
        valid = torch.as_tensor(np.arange(n_slots) < n_k[:, None])
        need = torch.as_tensor(query.coverage_need(theta, n_k))
        want = np.stack([_reference_msmt(kind, theta, int(n))[i]
                         for i, n in enumerate(lens)])
    got = teng.coverage_batch(reads, theta, valid=valid, need=need)
    rule = state_mod.verdicts(teng.state.meta, teng.query_batch(reads),
                              theta, valid=valid, need=need)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert got.shape == (len(reads), 1 if kind == "bloom"
                         else teng.n_files)
    assert torch.equal(got, rule)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    if padding == "none":
        assert torch.equal(teng.msmt(reads, theta), got)


# -- minimizer sub-sampling --------------------------------------------------

@pytest.mark.parametrize("read_len", [35, 60, 230])
@pytest.mark.parametrize("w", [1, 8, 16])
@pytest.mark.parametrize("m", [1 << 20, 1 << 32])
def test_minimizer_mask_matches_reference(read_len, w, m):
    """Reads shorter than the window (every kmer kept) and longer; at
    m = 2^32 the ranks' locations reach bit 31."""
    jc, tc = _cfgs(m=m)
    reads = np.random.default_rng(read_len + w).integers(
        0, 4, size=(5, read_len), dtype=np.uint8)
    locs = np.asarray(j_packed.batch_locations(jc, jnp.asarray(reads), "idl"))
    want = np.asarray(j_ingest.minimizer_mask(jnp.asarray(locs), w))
    got = ingest.minimizer_mask(torch.from_numpy(locs.astype(np.int64)), w)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    if read_len - 30 < w or w == 1:
        assert want.all()
    else:
        assert 0 < want.sum() < want.size


@pytest.mark.parametrize("kind", ["bits", "cols", "rows"])
def test_insert_plan_window_min_matches_reference(kind):
    jc, tc = _cfgs()
    reads = np.random.default_rng(5).integers(0, 4, size=(4, 120),
                                              dtype=np.uint8)
    shape = {"bits": (jc.m // 32, 1), "cols": (jc.m, 2),
             "rows": (6, jc.m // 32)}[kind]
    aux = {"bits": None, "cols": np.array([0, 5, 63, 5]),
           "rows": np.array([[0, 3], [1, 4], [2, 5], [0, 5]])}[kind]
    jp = j_ingest.plan_insert(jc, "idl", reads.shape, shape, kind=kind,
                              window_min=8)
    tp = ingest.plan_insert(tc, "idl", reads.shape, shape, kind=kind,
                            window_min=8, device="cpu")
    assert (tp.window_min, tp.rows_per_block) == (8, jp.rows_per_block)
    jaux = None if aux is None else jnp.asarray(aux.astype(np.int32))
    jr = jp.plan_runs(jnp.asarray(reads), jaux)
    tr = tp.plan_runs(torch.from_numpy(reads),
                      None if aux is None else torch.from_numpy(aux))
    for field in ("n_locs", "n_runs", "n_tiles", "dma_bytes"):
        assert getattr(tr, field) == getattr(jr, field)
    want = np.asarray(j_ingest.plan_insert(
        jc, "idl", reads.shape, shape, kind=kind).plan_runs(
            jnp.asarray(reads), jaux).n_locs)
    assert jr.n_locs < want               # the mask dropped targets
    for backend in ingest.BACKENDS:
        mat = torch.zeros(shape, dtype=torch.int32)
        tp.execute(mat, reads, aux, backend=backend)
        np.testing.assert_array_equal(
            _u32(mat), np.asarray(jp.execute(
                jnp.zeros(shape, jnp.uint32), jnp.asarray(reads), jaux)))


# -- the dedup path and the plan caches ---------------------------------------

def _overlapping_reads(n=12, read_len=90, seed=6):
    """Reads from a few start positions of one sequence: many kmers repeat."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=400, dtype=np.uint8)
    starts = rng.choice([0, 7, 8, 150], size=n)
    return np.stack([g[s:s + read_len] for s in starts])


def test_factor_unique_kmers_matches_reference():
    reads = _overlapping_reads()
    np.testing.assert_array_equal(query.read_kmers(reads, 31),
                                  j_query.read_kmers(reads, 31))
    np.testing.assert_array_equal(query.read_kmers(reads[0], 31),
                                  j_query.read_kmers(reads[0], 31))
    uniq, inv, shape = query.factor_unique_kmers(reads, 31)
    juniq, jinv, jshape = j_query.factor_unique_kmers(reads, 31)
    np.testing.assert_array_equal(uniq, juniq)
    np.testing.assert_array_equal(inv, jinv)
    assert shape == jshape == (12, 60)
    assert len(uniq) < 12 * 60
    duniq, dinv, dshape = query.factor_unique_kmers_device(
        torch.from_numpy(reads), 31)
    np.testing.assert_array_equal(duniq.numpy(), juniq)
    np.testing.assert_array_equal(dinv.numpy(), jinv)
    assert dshape == jshape


# (bit_probe, W, lane32): the flat filter, RAMBO's wide rows, a row matrix
DEDUP_CASES = [(True, 1, False), (True, 6, False), (False, 2, True)]


@pytest.mark.parametrize("bit_probe,w,lane32", DEDUP_CASES)
@pytest.mark.parametrize("scheme", ["idl", "rh"])
def test_dedup_execute_matches_reference(bit_probe, w, lane32, scheme):
    """``execute(dedup=True)`` on both backends equals the reference's dedup
    path and the port's own naive path, and the dedup plan's locality
    counters equal the reference's (same distinct kmers, pad and sort)."""
    jc, tc = _cfgs(m=1 << 16)
    n_rows = jc.m // 32 if bit_probe else jc.m
    words = np.random.default_rng(w).integers(
        0, 2 ** 32, size=(n_rows, w), dtype=np.uint64).astype(np.uint32)
    words[np.random.default_rng(9).random(words.shape) < 0.5] = 0xFFFFFFFF
    reads = _overlapping_reads()
    jp = j_query.plan_query(jc, scheme, reads.shape, (n_rows, w),
                            bit_probe=bit_probe, lane32=lane32)
    tp = query.plan_query(tc, scheme, reads.shape, (n_rows, w),
                          bit_probe=bit_probe, lane32=lane32, device="cpu")
    mat = torch.from_numpy(words.view(np.int32).copy())
    want = np.asarray(jp.execute(jnp.asarray(words), jnp.asarray(reads),
                                 dedup=True))
    assert 0 < want.sum()
    np.testing.assert_array_equal(
        want, np.asarray(jp.execute(jnp.asarray(words), jnp.asarray(reads))))
    naive = tp.execute(mat, reads)
    for backend in query.BACKENDS:
        got = tp.execute(mat, reads, backend=backend, dedup=True)
        assert got.shape == naive.shape == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        assert torch.equal(got, naive)
    j_metrics.reset()
    t_metrics.reset()
    jp.execute(jnp.asarray(words), jnp.asarray(reads), backend="idl_probe",
               dedup=True, use_ref=True)
    tp.execute(mat, reads, backend="idl_probe", dedup=True)
    j_snap, t_snap = j_metrics.DEFAULT.snapshot(), t_metrics.DEFAULT.snapshot()
    where = {"scheme": scheme, "op": "query"}
    for name in ("locality.planned_tile_bytes", "locality.probe_runs",
                 "locality.probes", "locality.batches"):
        want_c = j_metrics.counter_total(j_snap, name, where)
        assert want_c > 0
        assert t_metrics.counter_total(t_snap, name, where) == want_c


@pytest.mark.parametrize("kind", ["cobs", "rambo"])
def test_engine_dedup_equals_naive(kind):
    jeng, ports = _built(kind, "idl", None)
    g = _genomes(kind)
    reads = np.stack([g[0, s:s + 230] for s in (0, 3, 3, 40, 0, 41)])
    want = np.asarray(jeng.msmt(jnp.asarray(reads), dedup=True))
    teng = ports["idl_insert"]
    for backend in query.BACKENDS:
        got = teng.msmt(reads, backend=backend, dedup=True)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, teng.msmt(reads, backend=backend))
        assert torch.equal(teng.query_batch(reads, backend=backend,
                                            dedup=True),
                           teng.query_batch(reads, backend=backend))


@pytest.mark.parametrize("layer", ["query", "ingest"])
def test_plan_cache_info_matches_reference(layer):
    """Hits, misses, size and evictions of the bounded plan caches, after
    more distinct geometries than the cache holds."""
    jc, tc = _cfgs()
    jmod, tmod = (j_query, query) if layer == "query" else (j_ingest, ingest)
    shape = (jc.m, 2)

    def plan(mod, cfg, b, **kw):
        if layer == "query":
            return mod.plan_query(cfg, "idl", (b, 100), shape,
                                  bit_probe=False, **kw)
        return mod.plan_insert(cfg, "idl", (b, 100), shape, kind="cols",
                               **kw)

    infos = []
    for mod, cfg, kw in ((jmod, jc, {}), (tmod, tc, {"device": "cpu"})):
        mod.clear_plan_cache()
        for b in range(1, mod.PLAN_CACHE_SIZE + 6):
            plan(mod, cfg, b, **kw)
        for b in (mod.PLAN_CACHE_SIZE + 5, mod.PLAN_CACHE_SIZE + 4):
            plan(mod, cfg, b, **kw)                     # two hits
        infos.append(mod.plan_cache_info())
        mod.clear_plan_cache()
        assert mod.plan_cache_info().currsize == 0
    assert tuple(infos[1]) == tuple(infos[0])
    assert infos[1].evictions == 5 and infos[1].hits == 2
    assert infos[1]._fields == infos[0]._fields


# -- state, snapshots, service, adapters -------------------------------------

@pytest.mark.parametrize("kind", ["cobs", "rambo"])
def test_state_round_trip(kind):
    jeng, ports = _built(kind, "idl", None)
    teng = ports["idl_insert"]
    st = teng.state
    assert store.meta_to_json(st.meta) == j_store.meta_to_json(
        jeng.state.meta)
    back = state_mod.to_engine(st)
    assert type(back) is type(teng)
    for a, b in zip(back.state.words, st.words):
        assert a is b
    reads = _queries(kind)
    assert torch.equal(state_mod.msmt(st, reads, theta=0.6),
                       teng.msmt(reads, theta=0.6))
    carried = state_mod.from_numpy(
        j_store.meta_to_json(jeng.state.meta),
        [np.asarray(w) for w in jeng.state.words], device="cpu")
    assert carried.meta == st.meta
    for a, b in zip(carried.words, st.words):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["cobs", "rambo"])
def test_snapshots_both_directions(kind, tmp_path):
    jeng, ports = _built(kind, "idl", None)
    teng = ports["idl_insert"]
    reads = _queries(kind)
    want = np.asarray(jeng.msmt(jnp.asarray(reads), theta=0.6))
    j_store.save(jeng, str(tmp_path / "ref"))
    loaded = store.load(str(tmp_path / "ref"), device="cpu")
    assert len(loaded.words) == (3 if kind == "cobs" else 1)
    np.testing.assert_array_equal(
        state_mod.msmt(loaded, reads, theta=0.6).numpy(), want)
    store.save(teng, str(tmp_path / "port"))
    back = j_store.load(str(tmp_path / "port"))
    assert back.meta == jeng.state.meta
    np.testing.assert_array_equal(
        np.asarray(j_store.load_engine(str(tmp_path / "port")).msmt(
            jnp.asarray(reads), theta=0.6)), want)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ref").iterdir())


@pytest.mark.parametrize("theta", [1.0, 0.6])
@pytest.mark.parametrize("backend", ["idl_probe", "torch"])
@pytest.mark.parametrize("kind", ["cobs", "rambo"])
def test_service_matches_reference_service(kind, backend, theta):
    jeng, ports = _built(kind, "idl", None)
    g = _genomes(kind)
    rng = np.random.default_rng(int(theta * 10))
    queries = []
    for i in range(9):                  # ragged: several kmer buckets
        length = int(rng.integers(40, 200))
        if i % 3 == 2:
            queries.append(rng.integers(0, 4, size=length, dtype=np.uint8))
        else:
            s = int(rng.integers(0, 400 - length))
            queries.append(g[i % len(g), s:s + length])
    jsvc = j_service.GeneSearchService(
        jeng, j_service.ServiceConfig(theta=theta, max_batch=4))
    tsvc = service.GeneSearchService(
        ports["idl_insert"], service.ServiceConfig(theta=theta, max_batch=4,
                                                   backend=backend))
    buckets = set()
    for a, b in zip(tsvc.search(queries), jsvc.search(queries)):
        np.testing.assert_array_equal(a.matches, np.asarray(b.matches))
        assert (a.file_ids, a.n_kmers, a.bucket) == \
            (b.file_ids, b.n_kmers, b.bucket)
        buckets.add(a.bucket)
    assert len(buckets) > 1 and 0 < tsvc.occupancy() < 1


def test_cobs_adapter_matches_reference():
    jc, tc = _cfgs()
    g = _genomes("cobs")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ja = j_cobs.Cobs.build(COBS_SIZES, jc, n_groups=3)
        with pytest.warns(DeprecationWarning):
            ta = cobs.Cobs.build(COBS_SIZES, tc, n_groups=3, device="cpu")
    first = ta
    for fid in range(len(g)):
        ja = ja.insert_sequence(fid, jnp.asarray(g[fid]))
        ta = ta.insert_sequence(fid, g[fid])
    assert not first.query_sequence(g[0, :100]).any()  # the seed's values
    assert (ta.n_files, ta.k, ta.total_bits) == (ja.n_files, ja.k,
                                                 ja.total_bits)
    assert len(ta.groups) == len(ja.groups)
    for q in (g[2, 10:200], g[4]):
        np.testing.assert_array_equal(ta.query_sequence(q).numpy(),
                                      np.asarray(ja.query_sequence(
                                          jnp.asarray(q))))
        for theta in (1.0, 0.6):
            np.testing.assert_array_equal(
                ta.msmt(q, theta).numpy(),
                np.asarray(ja.msmt(jnp.asarray(q), theta)))


def test_rambo_adapter_matches_reference():
    jc, tc = _cfgs(m=1 << 14)
    g = _genomes("rambo")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ja = j_rambo.Rambo.build(N_RAMBO, jc, B=N_BUCKETS, R=N_REP)
        with pytest.warns(DeprecationWarning):
            ta = rambo.Rambo.build(N_RAMBO, tc, B=N_BUCKETS, R=N_REP,
                                   device="cpu")
    assert ta.filters.dtype == torch.uint8
    np.testing.assert_array_equal(ta.assignment, ja.assignment)
    for fid in range(len(g)):
        ja = ja.insert_sequence(fid, jnp.asarray(g[fid]))
        ta = ta.insert_sequence(fid, g[fid])
    np.testing.assert_array_equal(ta.filters.numpy(), np.asarray(ja.filters))
    assert ta.total_bits == ja.total_bits
    q = g[3, 20:250]
    np.testing.assert_array_equal(ta.query_kmer_grid(q).numpy(),
                                  np.asarray(ja.query_kmer_grid(
                                      jnp.asarray(q))))
    for theta in (1.0, 0.6):
        np.testing.assert_array_equal(
            ta.msmt(q, theta).numpy(),
            np.asarray(ja.msmt(jnp.asarray(q), theta)))


# -- the gather's bit mode ---------------------------------------------------

@pytest.mark.parametrize("w", [1, 8, 40])
@pytest.mark.parametrize("eta", [1, 3, 4])
def test_bit_mode_plain_vs_reference_kernel(w, eta):
    """The bit mode's plain version (what a CPU matrix runs, through the
    wrapper and a compact plan) against the reference's probe_rows in
    interpret mode followed by its bit extraction and AND over eta;
    locations on bit 31 and in the last row included."""
    rng = np.random.default_rng(10 * w + eta)
    n_rows = 128
    words = rng.integers(0, 2 ** 32, size=(n_rows, w), dtype=np.uint64
                         ).astype(np.uint32)
    words[rng.random(words.shape) < 0.6] = 0xFFFFFFFF
    locs = rng.integers(0, 32 * n_rows, size=(3, eta, 17))
    locs[:, :, ::4] |= 31
    locs[2, :, 0] = 32 * n_rows - 1
    b = 3
    jplan = j_probe_ops.plan_probe_runs((locs >> 5).reshape(b * eta, 17),
                                        block_bits=8, probes_per_run=16)
    gathered = j_probe_ops.gather_planned_rows(jnp.asarray(words), jplan,
                                               interpret=True)
    want = np.asarray(j_query._finish_probe(
        gathered.reshape(b, eta, 17, w), jnp.asarray(locs.astype(np.uint32)),
        bit_probe=True))
    assert 0 < want.sum() < want.size
    mat = torch.from_numpy(words.view(np.int32).copy())
    tlocs = torch.from_numpy(locs)
    got = probe_ref.gather_bits_and_ref(mat, tlocs)
    assert got.dtype == torch.int32 and got.shape == (3, 17, w)
    np.testing.assert_array_equal(got.numpy(), want)
    before = probe_kernel.bit_mode_launches
    plan = probe_ops.compact_probe_plan(tlocs, 8 * 32, 16)
    np.testing.assert_array_equal(
        probe_kernel.gather_planned_bits(mat, plan).numpy(), want)
    assert probe_kernel.bit_mode_launches == before      # CPU: no launch
    with pytest.raises(ValueError):
        probe_kernel.gather_planned_bits(mat, tlocs + 32 * n_rows)
    with pytest.raises(ValueError):
        probe_kernel.gather_planned_bits(mat.reshape(-1), tlocs)


@pytest.mark.parametrize("w,route", [(1, "probe_planned_bits"),
                                     (8, "probe_planned_bits"),
                                     (9, "gather_planned_bits"),
                                     (320, "gather_planned_bits")])
def test_bit_probes_route_by_row_width(monkeypatch, w, route):
    """A bit probe of rows of up to 8 words (the flat filter's one) takes
    probe_planned_bits; of wider rows (RAMBO's R·B) the gather's bit
    mode."""
    assert query.PROBE_BITS_MAX_WORDS == 8
    jc, tc = _cfgs(m=1 << 16)
    calls = []
    for name in ("probe_planned_bits", "gather_planned_bits",
                 "gather_planned_rows"):
        fn = getattr(probe_kernel, name)
        monkeypatch.setattr(probe_kernel, name,
                            lambda *a, _f=fn, _n=name: calls.append(_n)
                            or _f(*a))
    tp = query.plan_query(tc, "idl", (2, 60), (tc.m // 32, w),
                          bit_probe=True, device="cpu")
    tp.execute(torch.zeros((tc.m // 32, w), dtype=torch.int32),
               np.zeros((2, 60), np.uint8), backend="idl_probe")
    assert calls == [route]
