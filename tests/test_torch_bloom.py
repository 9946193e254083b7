"""PyTorch port vs the JAX reference for the flat IDL Bloom filter: the
bit-per-byte primitives and the packed layout, the BloomFilter adapter, the
flat-filter kernels' plain versions against the reference's Pallas kernels
(interpret mode), the bit-probe query and "bits" insert plans on the 64-bit
path, PackedBloomIndex, its state and snapshots, and the service over it.
Every comparison is exact."""

import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import bloom as j_bloom  # noqa: E402
from repro.core import idl as j_idl  # noqa: E402
from repro.data import genome as j_genome  # noqa: E402
from repro.index import engines as j_engines  # noqa: E402
from repro.index import ingest as j_ingest  # noqa: E402
from repro.index import query as j_query  # noqa: E402
from repro.index import store as j_store  # noqa: E402
from repro.kernels.idl_insert import ops as j_ins_ops  # noqa: E402
from repro.kernels.idl_insert import ref as j_ins_ref  # noqa: E402
from repro.kernels.idl_probe import ops as j_probe_ops  # noqa: E402
from repro.kernels.idl_probe import ref as j_probe_ref  # noqa: E402
from repro.serving import service as j_service  # noqa: E402
from repro_torch.core import bloom, idl, kmers  # noqa: E402
from repro_torch.data import genome  # noqa: E402
from repro_torch.index import engines, ingest, query, store  # noqa: E402
from repro_torch.index import state as state_mod  # noqa: E402
from repro_torch.kernels.idl_insert import kernel as ins_kernel  # noqa: E402
from repro_torch.kernels.idl_insert import ops as ins_ops  # noqa: E402
from repro_torch.kernels.idl_insert import ref as ins_ref  # noqa: E402
from repro_torch.kernels.idl_probe import kernel as probe_kernel  # noqa: E402
from repro_torch.kernels.idl_probe import ops as probe_ops  # noqa: E402
from repro_torch.kernels.idl_probe import ref as probe_ref  # noqa: E402
from repro_torch.serving import service  # noqa: E402

SCHEMES = ("idl", "rh", "lsh", "idl-bbf")
CFG = dict(k=31, t=12, L=1 << 10, eta=2, m=1 << 16)


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return j_idl.IDLConfig(**kw), idl.IDLConfig(**kw)


def _u32(t: "torch.Tensor") -> np.ndarray:
    return t.numpy().view(np.uint32)


def _i32(words: np.ndarray) -> "torch.Tensor":
    return torch.from_numpy(np.asarray(words).view(np.int32).copy())


def _j_filter(jc, codes, scheme="idl"):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return j_bloom.BloomFilter(cfg=jc, scheme=scheme).insert_sequence(
            jnp.asarray(codes))


def _t_filter(tc, codes, scheme="idl"):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return bloom.BloomFilter(cfg=tc, scheme=scheme, device="cpu"
                                 ).insert_sequence(codes)


# -- bit-per-byte primitives, the packed layout, blocked locations -----------

def test_primitives_and_packed_layout(rng):
    m = 1 << 12
    locs = rng.integers(0, m, size=(3, 200))
    jbf = j_bloom.insert_locations(j_bloom.empty_filter(m), jnp.asarray(locs))
    tbf = bloom.insert_locations(bloom.empty_filter(m, "cpu"),
                                 torch.from_numpy(locs))
    np.testing.assert_array_equal(tbf.numpy(), np.asarray(jbf))
    q = np.concatenate([locs[:, :50], rng.integers(0, m, size=(3, 50))], 1)
    np.testing.assert_array_equal(
        bloom.query_locations(tbf, torch.from_numpy(q)).numpy(),
        np.asarray(j_bloom.query_locations(jbf, jnp.asarray(q))))
    jw = np.asarray(j_bloom.pack_bits(jbf))
    tw = bloom.pack_bits(tbf)
    np.testing.assert_array_equal(_u32(tw), jw)
    np.testing.assert_array_equal(bloom.unpack_bits(tw).numpy(),
                                  np.asarray(j_bloom.unpack_bits(jw)))
    np.testing.assert_array_equal(
        bloom.query_packed(tw, torch.from_numpy(q)).numpy(),
        np.asarray(j_bloom.query_packed(jnp.asarray(jw),
                                        jnp.asarray(q.astype(np.uint32)))))
    np.testing.assert_array_equal(
        probe_ref.query_membership_ref(tw, torch.from_numpy(q)).numpy(),
        np.asarray(j_probe_ref.query_membership_ref(
            jnp.asarray(jw), jnp.asarray(q.astype(np.uint32)))))
    with pytest.raises(ValueError):
        bloom.pack_bits(torch.zeros(33, dtype=torch.uint8))


@pytest.mark.parametrize("m,eta,block_bits", [(1 << 16, 4, 512),
                                              (1 << 32, 3, 1 << 9)])
def test_blocked_locations(rng, m, eta, block_bits):
    km = rng.integers(0, 2 ** 62, size=300)
    want = np.asarray(j_bloom.blocked_locations(
        jnp.asarray(km.astype(np.uint64)), m, eta, block_bits))
    got = bloom.blocked_locations(torch.from_numpy(km), m, eta, block_bits)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (got // block_bits == got[0] // block_bits).all()


@pytest.mark.parametrize("scheme", ["idl", "rh"])
def test_bloom_filter_adapter(rng, scheme):
    jc, tc = _cfgs()
    codes = rng.integers(0, 4, size=600, dtype=np.uint8)
    with pytest.warns(DeprecationWarning):
        bloom.BloomFilter(cfg=tc, device="cpu")
    jbf, tbf = _j_filter(jc, codes, scheme), _t_filter(tc, codes, scheme)
    np.testing.assert_array_equal(tbf.bits.numpy(), np.asarray(jbf.bits))
    neg = rng.integers(0, 4, size=300, dtype=np.uint8)
    for q in (codes[100:300], neg):
        np.testing.assert_array_equal(
            tbf.query_sequence(q).numpy(),
            np.asarray(jbf.query_sequence(jnp.asarray(q))))
        assert bool(tbf.membership(q)) == bool(jbf.membership(jnp.asarray(q)))
    assert bool(tbf.membership(codes[:200]))
    assert float(tbf.fill_fraction) == float(jbf.fill_fraction)
    km = kmers.pack_kmers(torch.from_numpy(neg), 31)
    jkm = jnp.asarray(km.numpy().astype(np.uint64))
    jbf2, tbf2 = jbf.insert_kmers(jkm), tbf.insert_kmers(km)
    np.testing.assert_array_equal(tbf2.bits.numpy(), np.asarray(jbf2.bits))
    np.testing.assert_array_equal(tbf2.query_kmers(km).numpy(),
                                  np.asarray(jbf2.query_kmers(jkm)))
    assert bool(tbf2.query_kmers(km).all())


# -- the flat-filter kernels' plain versions vs the Pallas kernels -----------

def _built_words(rng, jc, n=1500):
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    return codes, np.asarray(j_bloom.pack_bits(_j_filter(jc, codes).bits))


@pytest.mark.parametrize("L,eta,m,C", [
    (1 << 12, 4, 1 << 20, 128),
    (1 << 10, 2, 1 << 18, 64),
    (1 << 14, 8, 1 << 22, 256),
])
def test_probe_membership_vs_reference(rng, L, eta, m, C):
    jc, tc = _cfgs(t=16, L=L, eta=eta, m=m)
    codes, words = _built_words(rng, jc)
    locs = np.asarray(j_idl.idl_locations_rolling(jc, jnp.asarray(codes)))
    jplan = j_probe_ops.plan_probe_runs(locs, block_bits=L, probes_per_run=C)
    interp = np.asarray(j_probe_ops.probe_membership(
        jnp.asarray(words), jplan, interpret=True))
    use_ref = np.asarray(j_probe_ops.probe_membership(
        jnp.asarray(words), jplan, use_ref=True))
    direct = np.asarray(j_bloom.query_packed(
        jnp.asarray(words), jnp.asarray(locs.astype(np.uint32))))
    plan = probe_ops.plan_probe_runs(locs, block_bits=L, probes_per_run=C)
    before = probe_kernel.bits_launches
    got = probe_ops.probe_membership(_i32(words), plan).numpy()
    assert probe_kernel.bits_launches == before   # plain version on the CPU
    for want in (interp, use_ref, direct):
        np.testing.assert_array_equal(got, want)
    assert got.all()                              # inserted -> all present
    # the plain versions, layout by layout
    args = (jnp.asarray(words), jnp.asarray(jplan.block_ids),
            jnp.asarray(jplan.offsets))
    jbits = np.asarray(j_probe_ref.probe_runs_ref(
        *args, block_words=L // 32, probes_per_run=C))
    tbits = probe_ref.probe_runs_ref(
        _i32(words), torch.from_numpy(plan.block_ids),
        torch.from_numpy(plan.offsets), block_words=L // 32,
        probes_per_run=C)
    np.testing.assert_array_equal(tbits.numpy(), jbits)
    np.testing.assert_array_equal(
        probe_ops.scatter_and_reduce(tbits, plan).numpy(),
        np.asarray(j_probe_ops.scatter_and_reduce(jnp.asarray(jbits), jplan)))


def test_probe_membership_negative_queries(rng):
    jc, tc = _cfgs(t=16, L=1 << 12, eta=4, m=1 << 20)
    _, words = _built_words(rng, jc)
    neg = rng.integers(0, 4, size=800, dtype=np.uint8)
    locs = np.asarray(j_idl.idl_locations_rolling(jc, jnp.asarray(neg)))
    plan = j_probe_ops.plan_probe_runs(locs, block_bits=jc.L)
    want = np.asarray(j_probe_ops.probe_membership(jnp.asarray(words), plan,
                                                   interpret=True))
    tlocs = idl.idl_locations_rolling(tc, torch.from_numpy(neg))
    np.testing.assert_array_equal(tlocs.numpy(), locs.astype(np.int64))
    tplan = probe_ops.plan_probe_runs(tlocs.numpy(), block_bits=tc.L)
    got = probe_ops.probe_membership(_i32(words), tplan).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got.all()
    np.testing.assert_array_equal(
        got, bloom.query_packed(_i32(words), tlocs).numpy())
    bad = probe_ops.plan_probe_runs(locs + (1 << 20), block_bits=jc.L)
    with pytest.raises(ValueError):
        probe_ops.probe_membership(_i32(words), bad)


@pytest.mark.parametrize("L,eta,m,C", [
    (1 << 12, 4, 1 << 20, 128),
    (1 << 10, 2, 1 << 18, 32),
])
def test_insert_with_plan_vs_reference(rng, L, eta, m, C):
    jc, tc = _cfgs(t=16, L=L, eta=eta, m=m)
    codes = rng.integers(0, 4, size=1200, dtype=np.uint8)
    locs = np.asarray(j_idl.idl_locations_rolling(jc, jnp.asarray(codes)))
    jplan = j_ins_ops.plan_insert_rounds(locs, block_bits=L,
                                         inserts_per_round=C)
    w0 = jnp.zeros((m // 32,), dtype=jnp.uint32)
    interp = np.asarray(j_ins_ops.insert_with_plan(w0, jplan, interpret=True))
    direct = np.asarray(j_bloom.pack_bits(_j_filter(jc, codes).bits))
    plan = ins_ops.plan_insert_rounds(locs, block_bits=L, inserts_per_round=C)
    words = torch.zeros(m // 32, dtype=torch.int32)
    before = ins_kernel.round_launches
    got = ins_ops.insert_with_plan(words, plan)
    assert ins_kernel.round_launches == before
    assert got is words                           # in place
    np.testing.assert_array_equal(_u32(got), interp)
    np.testing.assert_array_equal(_u32(got), direct)


def test_plan_insert_rounds_round_by_round(rng):
    jc, _ = _cfgs(t=16, L=1 << 10, eta=4, m=1 << 18)
    codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
    locs = np.asarray(j_idl.idl_locations_rolling(jc, jnp.asarray(codes)))
    jp = j_ins_ops.plan_insert_rounds(locs, jc.L, 64)
    tp = ins_ops.plan_insert_rounds(locs, jc.L, 64)
    assert len(tp.rounds) == len(jp.rounds) > 1
    assert (tp.n_locs, tp.n_tiles, tp.dma_bytes) == \
        (jp.n_locs, jp.n_tiles, jp.dma_bytes)
    words = rng.integers(0, 2 ** 32, size=jc.m // 32, dtype=np.uint64
                         ).astype(np.uint32)
    jw, tw = jnp.asarray(words), _i32(words)
    for (jb, jo), (tb, to) in zip(jp.rounds, tp.rounds):
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(to, jo)
        assert len(np.unique(tb)) == len(tb)
        jt = j_ins_ref.insert_round_ref(jw, jnp.asarray(jb), jnp.asarray(jo),
                                        block_words=jc.L // 32,
                                        inserts_per_round=64)
        tt = ins_ref.insert_round_ref(tw, torch.from_numpy(tb),
                                      torch.from_numpy(to),
                                      block_words=jc.L // 32,
                                      inserts_per_round=64)
        np.testing.assert_array_equal(_u32(tt), np.asarray(jt))
        jw = j_ins_ref.apply_insert_to_words(jw, jnp.asarray(jb), jt,
                                             jc.L // 32)
        ins_ref.apply_insert_to_words(tw, torch.from_numpy(tb), tt,
                                      jc.L // 32)
        np.testing.assert_array_equal(_u32(tw), np.asarray(jw))
    empty = ins_ops.plan_insert_rounds(np.zeros((4, 0), np.int64), jc.L)
    assert empty.rounds == [] and ins_ops.insert_with_plan(tw, empty) is tw


# -- bit-probe and "bits" plans on the 64-bit path ---------------------------

@pytest.mark.parametrize("scheme", ["idl", "rh"])
@pytest.mark.parametrize("backend", ["torch", "idl_probe"])
def test_bit_probe_query_plan_64bit(rng, scheme, backend):
    jc, tc = _cfgs()
    shape = (jc.m // 32, 1)
    words = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64
                         ).astype(np.uint32)
    words[rng.random(shape) > 0.9] = 0xFFFFFFFF
    reads = rng.integers(0, 4, size=(5, 90), dtype=np.uint8)
    jp = j_query.plan_query(jc, scheme, reads.shape, shape, bit_probe=True)
    tp = query.plan_query(tc, scheme, reads.shape, shape, bit_probe=True,
                          device="cpu")
    assert tp.lane32 is False
    want = np.asarray(jp.execute(jnp.asarray(words), jnp.asarray(reads),
                                 backend="jnp"))
    got = tp.execute(_i32(words), reads, backend=backend)
    np.testing.assert_array_equal(_u32(got), want)
    jr, jlocs = jp.plan_runs(jnp.asarray(reads))
    tr, tlocs = tp.plan_runs(torch.from_numpy(reads))
    np.testing.assert_array_equal(tlocs.numpy(), jlocs.astype(np.int64))
    np.testing.assert_array_equal(tr.offsets, jr.offsets)


@pytest.mark.parametrize("scheme", ["idl", "rh"])
@pytest.mark.parametrize("backend", ["torch", "idl_insert"])
def test_bits_insert_plan_64bit(rng, scheme, backend):
    jc, tc = _cfgs()
    shape = (jc.m // 32, 1)
    reads = rng.integers(0, 4, size=(6, 80), dtype=np.uint8)
    jp = j_ingest.plan_insert(jc, scheme, reads.shape, shape, kind="bits")
    tp = ingest.plan_insert(tc, scheme, reads.shape, shape, kind="bits",
                            device="cpu")
    words = np.zeros(shape, np.uint32)
    want = np.asarray(jp.execute(jnp.asarray(words), jnp.asarray(reads),
                                 backend="jnp"))
    got = tp.execute(_i32(words), reads, backend=backend)
    np.testing.assert_array_equal(_u32(got), want)
    assert tp.block_bits == jp.block_bits == jc.L


# -- PackedBloomIndex --------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
def test_packed_bloom_index_matches_reference(rng, scheme):
    jc, tc = _cfgs()
    jeng = j_engines.PackedBloomIndex.build(jc, scheme)
    teng = {b: engines.PackedBloomIndex.build(tc, scheme, device="cpu")
            for b in ("idl_insert", "torch")}
    for _ in range(2):
        reads = rng.integers(0, 4, size=(6, 100), dtype=np.uint8)
        jeng = jeng.insert_batch(jnp.asarray(reads))
        for b in teng:
            teng[b] = teng[b].insert_batch(reads, backend=b)
            np.testing.assert_array_equal(_u32(teng[b].words),
                                          np.asarray(jeng.words))
    eng = teng["idl_insert"]
    queries = np.concatenate(
        [reads[:3], rng.integers(0, 4, size=(3, 100), dtype=np.uint8)])
    want = np.asarray(jeng.query_batch(jnp.asarray(queries)))
    for backend in ("idl_probe", "torch"):
        np.testing.assert_array_equal(
            eng.query_batch(queries, backend=backend).numpy(), want)
        for theta in (1.0, 0.6):      # one file's column, (B, 1)
            np.testing.assert_array_equal(
                eng.msmt(queries, theta=theta, backend=backend).numpy(),
                np.asarray(jeng.msmt(jnp.asarray(queries),
                                     theta=theta))[:, None])
    assert eng.msmt(queries[:3]).all()
    assert float(eng.fill_fraction) == float(jeng.fill_fraction)
    np.testing.assert_array_equal(eng.bits.numpy(), np.asarray(jeng.bits))


def test_packed_bloom_index_state_and_guard(rng):
    _, tc = _cfgs()
    eng = engines.PackedBloomIndex.build(tc, "idl", device="cpu")
    reads = rng.integers(0, 4, size=(2, 60), dtype=np.uint8)
    kept = eng.insert_batch(reads, donate=False)
    assert int(eng.words.count_nonzero()) == 0      # input untouched
    new = eng.insert_batch(reads)
    assert torch.equal(new.words, kept.words)
    with pytest.raises(state_mod.StaleIndexError):
        eng.query_batch(reads)
    st = new.state
    assert st.meta == state_mod.StateMeta(engine="bloom", scheme="idl",
                                          cfgs=(tc,))
    back = state_mod.to_engine(st)
    assert isinstance(back, engines.PackedBloomIndex) and back.words is new.words
    st2 = state_mod.insert(st, reads[::-1].copy())
    with pytest.raises(state_mod.StaleIndexError):
        state_mod.query(st, reads)
    assert state_mod.msmt(st2, reads).all()
    with pytest.raises(ValueError):
        engines.PackedBloomIndex(cfg=idl.IDLConfig(m=(1 << 16) + 8, L=64),
                                 words=torch.zeros(1, dtype=torch.int32))


@pytest.fixture(scope="module")
def flat():
    """One small genome archive in a flat filter, built by both packages."""
    jc, tc = _cfgs(t=16, L=1 << 12, eta=4, m=1 << 20)
    g = genome.synthesize_genome(6000, seed=5)
    windows = genome.window_reads(g, 230, 31)
    jeng = j_engines.PackedBloomIndex.build(jc, "idl").insert_batch(
        jnp.asarray(windows))
    teng = ingest.build_archive(
        engines.PackedBloomIndex.build(tc, "idl", device="cpu"), [(0, g)],
        read_len=230, chunk_reads=8)
    return g, jeng, teng


def test_build_archive_matches_reference(flat):
    _, jeng, teng = flat
    np.testing.assert_array_equal(_u32(teng.words), np.asarray(jeng.words))


def test_flat_snapshots_both_ways(flat, tmp_path, rng):
    g, jeng, teng = flat
    reads = np.concatenate([genome.extract_reads(g, 120, 4, seed=1),
                            rng.integers(0, 4, size=(4, 120), dtype=np.uint8)])
    j_store.save(jeng, str(tmp_path / "ref"))
    st = store.load(str(tmp_path / "ref"), device="cpu")
    assert st.meta.engine == "bloom" and st.meta == teng.state.meta
    store.save(teng, str(tmp_path / "port"))
    back = j_store.load(str(tmp_path / "port"))
    assert json.load(open(tmp_path / "port" / "manifest.json"))["meta"] == \
        json.load(open(tmp_path / "ref" / "manifest.json"))["meta"]
    for theta in (1.0, 0.6):
        want = np.asarray(jeng.msmt(jnp.asarray(reads), theta=theta))
        np.testing.assert_array_equal(      # one file's column, (B, 1)
            state_mod.msmt(st, reads, theta=theta).numpy(), want[:, None])
        np.testing.assert_array_equal(
            np.asarray(j_engines.PackedBloomIndex(
                cfg=back.meta.cfgs[0], words=back.words[0]).msmt(
                    jnp.asarray(reads), theta=theta)), want)
    carried = state_mod.from_numpy(store.meta_to_json(jeng.state.meta),
                                   [np.asarray(jeng.words)], device="cpu")
    assert torch.equal(carried.words[0], teng.words)


@pytest.mark.parametrize("theta", [1.0, 0.6])
@pytest.mark.parametrize("backend", ["idl_probe", "torch"])
def test_service_over_flat_filter_matches_reference(flat, rng, theta,
                                                    backend):
    g, jeng, teng = flat
    queries = [np.asarray(g[s:s + n]) for s, n in
               zip(rng.integers(0, 5000, size=5), rng.integers(40, 160, 5))]
    queries += [rng.integers(0, 4, size=n, dtype=np.uint8) for n in (60, 100)]
    jsvc = j_service.GeneSearchService(
        jeng, j_service.ServiceConfig(theta=theta, max_batch=4))
    tsvc = service.GeneSearchService(
        teng, service.ServiceConfig(theta=theta, max_batch=4,
                                    backend=backend))
    assert tsvc.n_files == jsvc.n_files == 1
    got, want = tsvc.search(queries), jsvc.search(queries)
    for a, b in zip(got, want):       # the port's: one file's (1,) row
        assert a.matches.shape == (1,)
        assert a.matches[0] == bool(np.asarray(b.matches))
        assert (a.file_ids, a.n_kmers, a.bucket) == \
            (b.file_ids, b.n_kmers, b.bucket)
    assert all(r.file_ids == (0,) for r in got[:5])
    assert got[-1].file_ids == ()


@pytest.fixture(scope="module")
def flat_archive(tmp_path_factory):
    """Six seeded genomes in one flat filter, built by both packages, and
    the port's two-shard set of the same build."""
    jc, tc = _cfgs(t=16, L=1 << 11, eta=4, m=1 << 20)
    items = [(i, genome.synthesize_genome(1500 + 400 * i, seed=30 + i))
             for i in range(6)]
    windows = np.concatenate([genome.window_reads(g, 230, 31)
                              for _, g in items])
    jeng = j_engines.PackedBloomIndex.build(jc, "idl").insert_batch(
        jnp.asarray(windows))
    set_dir = str(tmp_path_factory.mktemp("flat") / "set")
    ingest.build_sharded_archive(
        engines.PackedBloomIndex.build(tc, "idl", device="cpu"), items,
        n_shards=2, out_dir=set_dir, read_len=230, chunk_reads=16)
    teng = ingest.build_archive(
        engines.PackedBloomIndex.build(tc, "idl", device="cpu"), items,
        read_len=230, chunk_reads=16)
    np.testing.assert_array_equal(_u32(teng.words), np.asarray(jeng.words))
    rng = np.random.default_rng(17)
    queries = [np.asarray(g[s:s + 120]) for _, g in items
               for s in rng.integers(0, 1300, size=2)]
    for q in queries[::3]:            # one changed base: some kmers miss
        q[60] = (q[60] + 1) % 4
    queries += [rng.integers(0, 4, size=n, dtype=np.uint8) for n in (80, 150)]
    return jeng, teng, set_dir, queries


@pytest.mark.parametrize("theta", [1.0, 0.8])
@pytest.mark.parametrize("path", ["service", "scatter"])
def test_flat_filter_answers_as_one_file(flat_archive, path, theta):
    """The served flat filter answers as an index of one file, where the
    reference answers a bool a read: each ``matches`` is a (1,) row equal
    to the reference service's verdict, through the service and through
    the scatter-gather router over a two-shard set."""
    from repro_torch.serving.scatter import ScatterConfig, ScatterGatherRouter

    jeng, teng, set_dir, queries = flat_archive
    want = j_service.GeneSearchService(
        jeng, j_service.ServiceConfig(theta=theta, max_batch=4)
    ).search(queries)
    cfg = service.ServiceConfig(theta=theta, max_batch=4)
    if path == "service":
        got = service.GeneSearchService(teng, cfg).search(queries)
    else:
        with ScatterGatherRouter(set_dir, ScatterConfig(
                service=cfg, device="cpu")) as router:
            got = [f.result(timeout=120)
                   for f in [router.submit(q) for q in queries]]
    verdicts = [bool(np.asarray(b.matches)) for b in want]
    assert any(verdicts) and not all(verdicts)
    for a, b, v in zip(got, want, verdicts):
        assert a.matches.shape == (1,) and a.matches.dtype == bool
        assert a.matches[0] == v
        assert a.file_ids == b.file_ids == ((0,) if v else ())
        assert a.n_kmers == b.n_kmers


def test_bit_probes_counted_by_path(flat):
    """Each served flat-filter batch counts one probe in
    ``index.bit_probes``: ``{path=plain}`` on a CPU filter (the kernel's
    plain version), never ``{path=kernel}``."""
    from repro_torch.obs import metrics as t_metrics

    g, _, teng = flat
    reads = genome.extract_reads(g, 120, 10, seed=4)

    def counted():
        snap = t_metrics.DEFAULT.snapshot()
        return {p: t_metrics.counter_total(snap, "index.bit_probes",
                                           {"path": p})
                for p in ("kernel", "plain")}

    before = counted()
    svc = service.GeneSearchService(teng, service.ServiceConfig(
        theta=1.0, max_batch=4, backend="idl_probe"))
    assert all(r.matches.all() for r in svc.search(list(reads)))
    after = counted()
    assert after["plain"] - before["plain"] == len(svc.batch_stats) == 3
    assert after["kernel"] == before["kernel"]


def test_plans_at_bit_offsets_past_2_31():
    """The flat filter's query and "bits" insert plans at m = 2**35 (4 GiB
    of words, never allocated): real IDL locations of a batch past 2**32
    and synthetic ones at 2**31, 2**32 and near 2**35 give the reference
    planners' run counts, run lengths and bounds, and the run plans' lanes
    go back to the same 64-bit positions."""
    m = 1 << 35
    cfg = idl.IDLConfig(k=31, t=16, L=1 << 13, eta=4, m=m)
    reads = genome.extract_reads(genome.synthesize_genome(4000, seed=8),
                                 230, 6, seed=2)
    locs = query.batch_locations(torch.as_tensor(reads), cfg=cfg,
                                 scheme="idl", lane32=False)
    part = locs // (m // 4)           # repetition j in its own part
    assert torch.equal(part, torch.arange(4)[None, :, None].expand_as(part))
    qplan = query.plan_query(cfg, "idl", reads.shape, (m // 32, 1),
                             bit_probe=True, device="cpu")
    cplan = qplan.compact_plan(torch.as_tensor(reads))
    rplan, _ = qplan.plan_runs(torch.as_tensor(reads))
    assert (cplan.n_runs, cplan.n_probes) == (rplan.n_runs, rplan.n_probes)
    assert (cplan.min_row, cplan.max_row) == (int(locs.min()),
                                              int(locs.max()))
    assert np.array_equal(cplan.run_lengths(), rplan.run_lengths)
    # the reference's run plan is of rows: words of a bit probe
    assert torch.equal(probe_ops.probe_order(rplan, m // cfg.L, "cpu"),
                       (locs >> 5).reshape(-1, locs.shape[-1]))
    iplan = ingest.plan_insert(cfg, "idl", reads.shape, (m // 32, 1),
                               kind="bits", device="cpu")
    assert torch.equal(iplan.flat_positions(torch.as_tensor(reads)),
                       locs.reshape(-1))
    streams = [locs.reshape(-1)]
    rng = np.random.default_rng(35)
    for top in (1 << 31, 1 << 32, m):  # synthetic positions at each edge
        near = top - 1 - rng.integers(0, 3 * cfg.L, size=2000)
        near[:50] = top - 1 - np.arange(50)          # one long run
        streams.append(torch.as_tensor(near))
    for flat in streams:
        c_ins = ins_ops.compact_insert_plan(flat, iplan.block_bits,
                                            iplan.inserts_per_run)
        r_ins = ins_ops.plan_insert_runs(flat.numpy(), iplan.block_bits,
                                         iplan.inserts_per_run)
        assert (c_ins.n_locs, c_ins.n_runs, c_ins.n_tiles) == \
            (r_ins.n_locs, r_ins.n_runs, r_ins.n_tiles)
        assert c_ins.max_position == int(flat.max())
        assert np.array_equal(c_ins.run_lengths(), r_ins.run_lengths)
        assert torch.equal(ins_kernel.lane_positions(
            torch.as_tensor(r_ins.block_ids[:r_ins.n_runs]),
            torch.as_tensor(r_ins.offsets[:r_ins.n_runs]), r_ins.block_bits),
            c_ins.positions)
        rows = flat.reshape(4, -1)
        c_q = probe_ops.compact_probe_plan(rows, cfg.L)
        r_q = probe_ops.plan_probe_runs(rows.numpy(), cfg.L)
        assert (c_q.n_runs, c_q.min_row, c_q.max_row) == \
            (r_q.n_runs, int(rows.min()), int(rows.max()))
        assert torch.equal(probe_ops.probe_order(r_q, m // cfg.L, "cpu"),
                           rows)


def test_end_to_end_gene_search_with_kernel_path():
    """The reference's system test, ported: index a genome through the
    BloomFilter adapter, plan each read's IDL locations, probe them through
    the probe_planned_bits path; genuine reads pass, poisoned reads fail,
    and IDL's plan needs far fewer runs than RH's."""
    g = genome.synthesize_genome(20_000, seed=0, repeat_fraction=0.0)
    np.testing.assert_array_equal(
        g, j_genome.synthesize_genome(20_000, seed=0, repeat_fraction=0.0))
    cfg = idl.IDLConfig(k=31, t=16, L=1 << 13, eta=4, m=1 << 23)
    words = bloom.pack_bits(_t_filter(cfg, g).bits)
    reads = genome.extract_reads(g, 230, 16, seed=1)
    poisoned = genome.poison_queries(reads, seed=2)
    for read, bad in zip(reads[:4], poisoned[:4]):
        for q, member in ((read, True), (bad, False)):
            locs = idl.idl_locations_rolling(cfg, torch.from_numpy(q))
            plan = probe_ops.plan_probe_runs(locs.numpy(), cfg.L)
            assert bool(probe_ops.probe_membership(words, plan).all()) \
                == member
    locs_idl = idl.idl_locations_rolling(cfg, torch.from_numpy(reads[0]))
    locs_rh = idl.rh_locations_rolling(cfg, torch.from_numpy(reads[0]))
    n_idl = probe_ops.plan_probe_runs(locs_idl.numpy(), cfg.L).n_runs
    n_rh = probe_ops.plan_probe_runs(locs_rh.numpy(), cfg.L).n_runs
    assert n_rh > 4 * n_idl
