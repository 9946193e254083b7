"""PyTorch port vs the JAX reference: sharded archives
(``index/shards.py``), the sharded build (``ingest.build_sharded_archive``)
and the scatter-gather tier (``serving/scatter.py``), plus the
``"sharded"`` query / ingest / service backends.

Partition and join round-trip bit-exactly, the parallel sharded build
equals the serial build and the reference's build word for word, merged
answers equal the reference's unsharded engines and services across
engines × schemes × thetas (in-process members and real shard processes),
and shard death keeps its exact semantics: row-probe answers name their
``missing_files``, bit-probe death fails loud with ``ShardDeadError``.
Shard sets are byte-compatible both ways. The reference's cases are those
of ``tests/test_shards.py``, at their sizes; every future has its own
timeout.
"""

import functools
import json
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import idl as j_idl  # noqa: E402
from repro.index import engines as j_engines  # noqa: E402
from repro.index import ingest as j_ingest  # noqa: E402
from repro.index import shards as j_shards  # noqa: E402
from repro.index import state as j_state  # noqa: E402
from repro.serving import service as j_service  # noqa: E402
from repro_torch.core import idl  # noqa: E402
from repro_torch.index import engines, ingest, query, shards, store  # noqa: E402
from repro_torch.index import state as state_mod  # noqa: E402
from repro_torch.serving import service as service_mod  # noqa: E402
from repro_torch.serving.kmer_cache import KmerCacheConfig  # noqa: E402
from repro_torch.serving.scatter import (  # noqa: E402
    ScatterConfig,
    ScatterGatherRouter,
    ShardDeadError,
    ShardSearchService,
)

ENGINES = ("bitsliced", "cobs", "bloom", "rambo")
SCHEMES = ("idl", "rh")
THETAS = (1.0, 0.6)
N_FILES = 70     # >= 3 bit-sliced word columns, so 2-3 file shards exist
TIMEOUT = 120
CPU = ScatterConfig(device="cpu")

_RNG = np.random.default_rng(0xC0FFEE)
FILES = [_RNG.integers(0, 4, size=(6, 120), dtype=np.uint8)
         for _ in range(N_FILES)]
READS = np.stack([FILES[i][0] for i in range(6)])
QUERIES = [_RNG.integers(0, 4, size=(int(n),), dtype=np.uint8)
           for n in _RNG.integers(40, 100, size=6)]
QUERIES[0] = FILES[3][0][:80].copy()     # true positives across the
QUERIES[1] = FILES[60][2][:60].copy()    # file-shard boundary


def _cfg(pkg):
    return pkg.IDLConfig(k=31, t=16, L=1 << 10, eta=2, m=1 << 14)


def _fresh_index(engine: str, scheme: str, port: bool = True):
    e, pkg = (engines, idl) if port else (j_engines, j_idl)
    kw = {"device": "cpu"} if port else {}
    if engine == "bitsliced":
        return e.BitSlicedIndex.build(_cfg(pkg), scheme=scheme,
                                      n_files=N_FILES, **kw)
    if engine == "cobs":
        return e.CobsIndex.build([f.size for f in FILES], _cfg(pkg),
                                 scheme=scheme, n_groups=3, **kw)
    if engine == "rambo":
        return e.RamboIndex.build(N_FILES, _cfg(pkg), scheme=scheme, **kw)
    return e.PackedBloomIndex.build(_cfg(pkg), scheme=scheme, **kw)


def _items(engine: str):
    # the flat filter indexes ONE set: give it a single concatenated file
    if engine == "bloom":
        return [(0, np.concatenate([f.ravel() for f in FILES[:4]]))]
    return list(enumerate(FILES))


def _words(state) -> list:
    """A state's word matrices as uint32 numpy arrays (either package)."""
    out = []
    for w in state.words:
        a = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        out.append(a.view(np.uint32))
    return out


def _assert_same_words(got, want):
    g, w = _words(got), _words(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Memoized (engine, scheme) -> (spec, states, set_dir, full): the
    port's parallel sharded build on the CPU + its saved shard set."""
    @functools.lru_cache(maxsize=None)
    def get(engine: str, scheme: str):
        out = str(tmp_path_factory.mktemp(f"{engine}-{scheme}") / "set")
        spec, states = ingest.build_sharded_archive(
            _fresh_index(engine, scheme), _items(engine), n_shards=2,
            out_dir=out, read_len=120, chunk_reads=8)
        return spec, states, out, shards.join_states(spec, states)

    return get


@pytest.fixture(scope="module")
def ref_built(tmp_path_factory):
    """The same build through the reference: (spec, states, set_dir,
    full)."""
    @functools.lru_cache(maxsize=None)
    def get(engine: str, scheme: str):
        out = str(tmp_path_factory.mktemp(f"ref-{engine}-{scheme}") / "set")
        spec, states = j_ingest.build_sharded_archive(
            _fresh_index(engine, scheme, port=False), _items(engine),
            n_shards=2, out_dir=out, read_len=120, chunk_reads=8)
        return spec, states, out, j_shards.join_states(spec, states)

    return get


@pytest.fixture(scope="module")
def ref_answers(ref_built):
    """Memoized (engine, scheme, theta) -> the reference's unsharded
    service's answers to ``QUERIES``."""
    @functools.lru_cache(maxsize=None)
    def get(engine: str, scheme: str, theta: float = 1.0):
        svc = j_service.GeneSearchService(
            ref_built(engine, scheme)[3],
            j_service.ServiceConfig(theta=theta, max_batch=4))
        return svc.search(QUERIES)

    return get


def _assert_results(got, want, *, missing=()):
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g.matches),
                                      np.asarray(w.matches))
        assert g.file_ids == w.file_ids
        assert g.n_kmers == w.n_kmers and g.bucket == w.bucket
        assert g.missing_files == missing


# ---------------------------------------------------------------------------
# The shard math: partition/join round trip + exact merged queries.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("engine", ENGINES)
class TestShardMath:

    def test_partition_join_roundtrip(self, built, ref_built, engine,
                                      scheme):
        """The port's partition of its joined build equals its shards and
        the reference's partition of the reference's build; the join
        restores the input; the slices are fresh dense tensors."""
        spec, states, _, full = built(engine, scheme)
        j_spec, j_states, _, j_full = ref_built(engine, scheme)
        spec2, parts = shards.partition_state(full, spec.n_shards)
        assert spec2 == spec
        assert spec.axis == j_spec.axis and spec.bounds == j_spec.bounds
        for got, want, ref in zip(parts, states, j_states):
            _assert_same_words(got, want)
            _assert_same_words(got, ref)
            assert all(w.is_contiguous() for w in got.words)
            assert all(w.data_ptr() != f.data_ptr()
                       for w in got.words for f in full.words)
        _assert_same_words(shards.join_states(spec, parts), full)
        _assert_same_words(full, j_full)

    def test_sharded_msmt_equals_oracle(self, built, ref_built, engine,
                                        scheme):
        spec, states, _, _ = built(engine, scheme)
        j_spec, j_states, _, j_full = ref_built(engine, scheme)
        oracle = j_state.to_engine(j_full)
        for theta in THETAS:
            want = np.asarray(oracle.msmt(jnp.asarray(READS), theta=theta))
            np.testing.assert_array_equal(
                np.asarray(j_shards.sharded_msmt(j_spec, j_states, READS,
                                                 theta=theta)), want)
            for backend in ("torch", "idl_probe"):
                got = shards.sharded_msmt(spec, states, READS, theta=theta,
                                          backend=backend)
                np.testing.assert_array_equal(
                    got.numpy(), want, err_msg=f"{theta} {backend}")

    def test_sharded_build_equals_serial_build(self, built, ref_built,
                                               engine, scheme):
        spec, states, _, _ = built(engine, scheme)
        serial = ingest.build_archive(
            _fresh_index(engine, scheme), _items(engine), read_len=120,
            chunk_reads=8)
        _, serial_parts = shards.partition_state(serial, spec.n_shards)
        _, j_states, _, _ = ref_built(engine, scheme)
        for got, want, ref in zip(states, serial_parts, j_states):
            _assert_same_words(got, want)
            _assert_same_words(got, ref)


# ---------------------------------------------------------------------------
# The scatter-gather tier (in-process members): bit-identical answers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("engine", ENGINES)
class TestScatterGatherParity:

    def test_router_equals_unsharded_service(self, built, ref_answers,
                                             engine, scheme):
        """The port's router over the port's shard set == the reference's
        service over the reference's unsharded index, at both thetas."""
        _, _, set_dir, _ = built(engine, scheme)
        for theta in THETAS:
            want = ref_answers(engine, scheme, theta)
            svc_cfg = service_mod.ServiceConfig(theta=theta, max_batch=4)
            with ScatterGatherRouter(set_dir, ScatterConfig(
                    service=svc_cfg, device="cpu")) as router:
                got = [f.result(timeout=TIMEOUT)
                       for f in [router.submit(q) for q in QUERIES]]
                assert all(g.version == router.set_version for g in got)
            _assert_results(got, want)


class TestScatterSurface:

    def test_stats_and_geometry_views(self, built):
        spec, _, set_dir, _ = built("bitsliced", "idl")
        with ScatterGatherRouter(set_dir, CPU) as router:
            assert router.n_shards == spec.n_shards
            assert router.spec == spec
            assert router.live_shards() == list(range(spec.n_shards))
            stats = router.stats()
            assert set(stats) == set(range(spec.n_shards))

    def test_router_rejects_malformed_reads(self, built):
        _, _, set_dir, _ = built("bitsliced", "idl")
        with ScatterGatherRouter(set_dir, CPU) as router:
            with pytest.raises(ValueError, match="one 1-D read"):
                router.submit(np.zeros((2, 120), dtype=np.uint8))
            with pytest.raises(ValueError, match="has no 31-mers"):
                router.submit(np.zeros((7,), dtype=np.uint8))

    def test_bit_probe_shard_service_refuses_kmer_cache(self, built):
        spec, states, _, _ = built("rambo", "idl")
        cfg = service_mod.ServiceConfig(
            kmer_cache=KmerCacheConfig(capacity=1 << 10))
        with pytest.raises(ValueError, match="partial miss counts"):
            ShardSearchService(spec, 0, states[0], cfg)

    def test_inprocess_kill_row_probe_names_missing_files(self, built,
                                                          ref_answers):
        spec, _, set_dir, _ = built("bitsliced", "idl")
        want = ref_answers("bitsliced", "idl")
        lost = shards.shard_files(spec, 1)
        kept = sorted(set(range(N_FILES)) - set(lost))
        with ScatterGatherRouter(set_dir, CPU) as router:
            router.submit(QUERIES[0]).result(timeout=TIMEOUT)
            router.kill_shard(1)
            res = [f.result(timeout=TIMEOUT)
                   for f in [router.submit(q) for q in QUERIES]]
            for r, w in zip(res, want):
                assert r.missing_files == lost
                assert not np.asarray(r.matches)[list(lost)].any()
                np.testing.assert_array_equal(
                    np.asarray(r.matches)[kept], np.asarray(w.matches)[kept])
            assert router.live_shards() == [0]


# ---------------------------------------------------------------------------
# Persistence: the CRC-checked shard-set manifest fails by name, and a
# shard set written by either package loads in the other.
# ---------------------------------------------------------------------------

class TestShardSetPersistence:

    def test_load_round_trip(self, built, tmp_path):
        spec, states, _, _ = built("rambo", "rh")
        out = str(tmp_path / "set")
        shards.save_shard_set(spec, states, out, version=7)
        sm, loaded = shards.load_shard_set(out, device="cpu")
        assert sm.spec == spec and sm.set_version == 7
        for got, want in zip(loaded, states):
            _assert_same_words(got, want)

    @pytest.mark.parametrize("engine", ENGINES)
    def test_shard_sets_load_both_ways_with_the_same_bytes(
            self, built, ref_built, engine):
        """Same inputs, same files: ``shardset.json`` and every shard's
        manifest are byte-identical, and each package loads the other's
        set to the same words and the same spec."""
        spec, states, set_dir, _ = built(engine, "idl")
        j_spec, j_states, j_dir, _ = ref_built(engine, "idl")
        names = [shards.SET_MANIFEST] + [
            os.path.join(f"shard_{s:02d}", store.MANIFEST)
            for s in range(spec.n_shards)]
        for name in names:
            with open(os.path.join(set_dir, name), "rb") as a, \
                    open(os.path.join(j_dir, name), "rb") as b:
                assert a.read() == b.read(), name
        sm, from_ref = shards.load_shard_set(j_dir, device="cpu")
        assert sm.spec == spec
        for got, want in zip(from_ref, states):
            _assert_same_words(got, want)
        j_sm, from_port = j_shards.load_shard_set(set_dir)
        assert j_sm.spec.bounds == spec.bounds
        for got, want in zip(from_port, j_states):
            _assert_same_words(got, want)

    @pytest.fixture()
    def set_copy(self, built, tmp_path):
        _, _, set_dir, _ = built("bitsliced", "idl")
        dst = str(tmp_path / "set")
        shutil.copytree(set_dir, dst)
        return dst

    def test_missing_shard_dir_fails_by_name(self, set_copy):
        shutil.rmtree(os.path.join(set_copy, "shard_01"))
        with pytest.raises(shards.ShardSetError,
                           match="'shard_01' is missing"):
            shards.load_shard_set(set_copy, device="cpu")

    def test_rewritten_shard_manifest_fails_by_name(self, set_copy):
        manifest = os.path.join(set_copy, "shard_00", "manifest.json")
        with open(manifest) as f:
            doc = json.load(f)
        with open(manifest, "w") as f:
            json.dump(doc, f, indent=3)     # same content, foreign bytes
        with pytest.raises(shards.ShardSetError,
                           match="foreign or rewritten"):
            shards.load_shard(set_copy, 0, device="cpu")

    def test_corrupt_set_manifest_fails_closed(self, set_copy):
        path = os.path.join(set_copy, shards.SET_MANIFEST)
        with open(path) as f:
            doc = json.load(f)
        doc["body"]["n_shards"] = 3         # body edit without new CRC
        with open(path, "w") as f:
            json.dump(doc, f)
        with pytest.raises(shards.ShardSetError,
                           match="truncated or rewritten"):
            shards.read_set_meta(set_copy)

    def test_store_load_points_at_shard_set_loader(self, set_copy):
        with pytest.raises(store.SnapshotError,
                           match="SHARD-SET snapshot"):
            store.load(set_copy, device="cpu")

    def test_store_read_meta_answers_with_full_meta(self, built):
        spec, _, set_dir, _ = built("bitsliced", "idl")
        assert store.read_meta(set_dir) == spec.meta

    def test_plan_rejects_infeasible_shard_counts(self, built):
        spec, _, _, _ = built("bitsliced", "idl")
        with pytest.raises(shards.ShardSetError, match="want 1 <="):
            shards.plan_shards(spec.meta, 1000)
        with pytest.raises(shards.ShardSetError, match="want 1 <="):
            shards.plan_shards(spec.meta, 0)


# ---------------------------------------------------------------------------
# The port's RAMBO word shard keeps its transposed copy.
# ---------------------------------------------------------------------------

def test_rambo_shard_keeps_its_transposed_copy(built, ref_built):
    """A RAMBO word shard's partial probes a ``(span, R·B)`` transpose made
    once and kept on the words tensor (the reference transposes on every
    call); a ShardBuilder insert drops it, and the next probe sees the new
    bits — equal to the reference's partial after the same insert."""
    spec, states, _, _ = built("rambo", "idl")
    j_spec, j_states, _, _ = ref_built("rambo", "idl")
    shard = state_mod.IndexState(words=(states[1].words[0].clone(),),
                                 meta=states[1].meta)
    words = shard.words[0]
    first = shards.shard_query(spec, 1, shard, READS)
    kept = getattr(words, engines._TRANSPOSED)
    assert kept is not None and kept.shape == words.shape[::-1]
    shards.shard_query(spec, 1, shard, READS)
    assert getattr(words, engines._TRANSPOSED) is kept
    np.testing.assert_array_equal(
        first.numpy(),
        np.asarray(j_shards.shard_query(j_spec, 1, j_states[1], READS)))
    new = np.roll(READS, 7, axis=1)
    built_shard = shards.ShardBuilder(spec, 1, shard).insert_batch(
        new, [2] * len(READS), backend="torch")
    assert getattr(words, engines._TRANSPOSED) is None
    j_new = j_shards.ShardBuilder(
        j_spec, 1, j_state.IndexState(words=(jnp.array(j_states[1].words[0]),),
                                      meta=j_states[1].meta)
    ).insert_batch(jnp.asarray(new), [2] * len(READS))
    probe = new
    np.testing.assert_array_equal(
        shards.shard_query(spec, 1, built_shard.state, probe).numpy(),
        np.asarray(j_shards.shard_query(j_spec, 1, j_new.state, probe)))
    assert getattr(words, engines._TRANSPOSED) is not None


@pytest.mark.parametrize("engine", ["bloom", "rambo"])
def test_shard_builder_kernel_backend_equals_plain(built, engine):
    """The port's ShardBuilder scatters through ``insert_planned`` (its
    plain version here) or the plain scatter: the same words."""
    spec, states, _, _ = built(engine, "idl")
    outs = []
    for backend in ("torch", "idl_insert"):
        b = shards.ShardBuilder(spec, 0, states[0]).insert_batch(
            np.roll(READS, 3, axis=1), [1] * len(READS), backend=backend,
            donate=False)
        outs.append(b.state)
    _assert_same_words(outs[0], outs[1])
    with pytest.raises(ValueError, match="scatters through"):
        shards.ShardBuilder(spec, 0, states[0]).insert_batch(
            READS, backend="sharded")


# ---------------------------------------------------------------------------
# The "sharded" backends: a mesh is a tuple of torch devices.
# ---------------------------------------------------------------------------

CPU_MESHES = {"one": (torch.device("cpu"),),
              "three": (torch.device("cpu"),) * 3}


@pytest.mark.parametrize("mesh", sorted(CPU_MESHES))
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_backends_equal_torch_and_reference(built, ref_built,
                                                    engine, scheme, mesh):
    """Query and ingest through ``"sharded"`` equal ``"torch"`` and the
    reference's ``jnp`` on the default mesh (one CPU device), and
    ``"torch"`` on a three-way split of the CPU (every shard's range, the
    miss-count sum and the concatenation run as on three devices)."""
    m = None if mesh == "one" else CPU_MESHES[mesh]
    if m is None:
        assert query.default_mesh("cpu") == CPU_MESHES["one"]
    _, _, _, full = built(engine, scheme)
    _, _, _, j_full = ref_built(engine, scheme)
    want = np.asarray(j_state.to_engine(j_full).query_batch(
        jnp.asarray(READS)))
    eng = state_mod.to_engine(full)
    np.testing.assert_array_equal(
        eng.query_batch(READS, backend="torch").numpy(), want)
    np.testing.assert_array_equal(
        eng.query_batch(READS, backend="sharded", mesh=m).numpy(), want)
    np.testing.assert_array_equal(
        eng.query_batch(READS, backend="sharded", mesh=m,
                        dedup=True).numpy(), want)
    fids = None if engine == "bloom" else np.arange(6) * 11 + 1
    new = np.roll(READS, 5, axis=1)
    plain = eng.insert_batch(new, fids, backend="torch", donate=False)
    sharded = eng.insert_batch(new, fids, backend="sharded", mesh=m,
                               donate=False)
    _assert_same_words(sharded.state, plain.state)
    if m is None:
        j_new = j_state.to_engine(j_full).insert_batch(
            jnp.asarray(new), fids, donate=False)
        _assert_same_words(sharded.state, j_state.from_engine(j_new))


def test_sharded_service_backend_equals_reference(built, ref_answers):
    _, _, _, full = built("bitsliced", "idl")
    svc = service_mod.GeneSearchService(
        full, service_mod.ServiceConfig(backend="sharded", max_batch=4))
    _assert_results(svc.search(QUERIES), ref_answers("bitsliced", "idl"))


@pytest.mark.skipif(not torch.cuda.is_available()
                    or torch.cuda.device_count() < 2,
                    reason="needs a multi-device mesh")
@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_multi_device(built, engine):
    """Every visible card as one mesh: the same answers and words as one
    device's plain backend."""
    eng = state_mod.to_engine(built(engine, "idl")[3])
    cuda = state_mod.to_engine(state_mod.IndexState(
        words=tuple(w.cuda() for w in eng.state.words), meta=eng.state.meta))
    want = eng.query_batch(READS, backend="torch")
    got = cuda.query_batch(READS, backend="sharded")
    assert torch.equal(got.cpu(), want)
    fids = None if engine == "bloom" else np.arange(6)
    new = np.roll(READS, 5, axis=1)
    a = eng.insert_batch(new, fids, backend="torch", donate=False)
    b = cuda.insert_batch(new, fids, backend="sharded", donate=False)
    for x, y in zip(a.state.words, b.state.words):
        assert torch.equal(x, y.cpu())


# ---------------------------------------------------------------------------
# Proc mode: real shard worker processes, one test per partition axis.
# ---------------------------------------------------------------------------

def _proc_router(set_dir, theta=1.0):
    return ScatterGatherRouter(set_dir, ScatterConfig(
        procs=True, device="cpu",
        service=service_mod.ServiceConfig(theta=theta, max_batch=4)))


class TestProcShards:

    def test_row_probe_procs_parity_then_kill(self, built, ref_answers):
        """2 bit-sliced shard processes: answers == the reference's
        unsharded service; kill -9 one shard mid-stream and every future
        still resolves, late answers naming the dead shard's files as
        missing; each shard's stats reply carries its device entry."""
        spec, _, set_dir, _ = built("bitsliced", "idl")
        want = ref_answers("bitsliced", "idl")
        with _proc_router(set_dir) as router:
            got = [f.result(timeout=TIMEOUT)
                   for f in [router.submit(q) for q in QUERIES]]
            _assert_results(got, want)
            stats = router.stats()
            assert set(stats) == {0, 1}
            for s in stats.values():
                assert s["device"]["max_memory_allocated"] == 0
                assert set(s["device"]["launches"]) >= {
                    "gather_planned_rows", "insert_planned", "window_min"}
            stream = [QUERIES[i % len(QUERIES)] for i in range(18)]
            futures = [router.submit(q) for q in stream]
            router.kill_shard(1)
            results = [f.result(timeout=TIMEOUT) for f in futures]
            lost = shards.shard_files(spec, 1)
            kept = sorted(set(range(N_FILES)) - set(lost))
            for w, r in zip((want[i % len(want)] for i in range(18)),
                            results):
                wm, gm = np.asarray(w.matches), np.asarray(r.matches)
                if r.missing_files:     # answered after the kill landed
                    assert r.missing_files == lost
                    assert not gm[list(lost)].any()
                np.testing.assert_array_equal(gm[kept], wm[kept])
            deadline = time.monotonic() + 30
            while len(router.live_shards()) > 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            assert router.live_shards() == [0]
            late = [f.result(timeout=TIMEOUT)
                    for f in [router.submit(q) for q in QUERIES]]
            for w, r in zip(want, late):
                assert r.missing_files == lost
                np.testing.assert_array_equal(
                    np.asarray(r.matches)[kept],
                    np.asarray(w.matches)[kept])

    def test_bit_probe_procs_parity_then_kill_fails_loud(self, built,
                                                         ref_answers):
        """2 rambo shard processes: answers == the reference's unsharded
        service at theta=0.6; kill -9 one shard and affected futures raise
        ShardDeadError — never a silently inflated answer, never a dropped
        future."""
        _, _, set_dir, _ = built("rambo", "idl")
        want = ref_answers("rambo", "idl", 0.6)
        with _proc_router(set_dir, theta=0.6) as router:
            got = [f.result(timeout=TIMEOUT)
                   for f in [router.submit(q) for q in QUERIES]]
            _assert_results(got, want)
            stream = [QUERIES[i % len(QUERIES)] for i in range(18)]
            futures = [router.submit(q) for q in stream]
            router.kill_shard(0)
            outcomes = {"ok": 0, "dead": 0}
            for i, f in enumerate(futures):
                try:
                    r = f.result(timeout=TIMEOUT)
                    np.testing.assert_array_equal(
                        np.asarray(r.matches),
                        np.asarray(want[i % len(want)].matches))
                    outcomes["ok"] += 1
                except ShardDeadError:
                    outcomes["dead"] += 1
            assert sum(outcomes.values()) == len(futures)   # zero dropped
            with pytest.raises(ShardDeadError, match="failing loud"):
                router.submit(QUERIES[0]).result(timeout=TIMEOUT)
