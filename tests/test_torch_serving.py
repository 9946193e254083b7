"""PyTorch port vs the JAX reference for the slice as a whole: snapshots
carried across, the serving front end, the launcher, and the port's
independence from JAX. Every comparison is exact."""

import json
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro_torch  # noqa: E402
from repro.configs import idl_genesearch as j_configs  # noqa: E402
from repro.data import genome as j_genome  # noqa: E402
from repro.index import engines as j_engines  # noqa: E402
from repro.index import store as j_store  # noqa: E402
from repro.serving import service as j_service  # noqa: E402
from repro_torch.configs import idl_genesearch  # noqa: E402
from repro_torch.data import genome  # noqa: E402
from repro_torch.index import engines, ingest, state as state_mod, store  # noqa: E402
from repro_torch.serving import service  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


@pytest.fixture(scope="module")
def built():
    """The smoke config over 64 synthetic genomes, built by both packages
    (the reference with its jnp backend, the port with idl_insert)."""
    cfg = idl_genesearch.smoke_config()
    jcfg = j_configs.smoke_config()
    archive = genome.synth_archive(cfg.n_files, genome_len=1500, seed=3)
    jeng = j_engines.BitSlicedIndex.build(jcfg.idl_config(), jcfg.scheme,
                                          jcfg.n_files)
    for f in archive:
        jeng = jeng.insert_batch(jnp.asarray(f.genome)[None],
                                 np.asarray([f.file_id], np.int32))
    teng = engines.BitSlicedIndex.build(cfg.idl_config(), cfg.scheme,
                                        cfg.n_files, device="cpu")
    teng = ingest.build_archive(teng, archive, read_len=cfg.read_len,
                                chunk_reads=16)
    return cfg, archive, jeng, teng


def _queries(archive, rng, n=10):
    """Ragged reads: substrings of indexed genomes and random reads."""
    out = []
    for i in range(n):
        length = int(rng.integers(40, 160))
        if i % 3 == 2:
            out.append(rng.integers(0, 4, size=length, dtype=np.uint8))
        else:
            g = archive[int(rng.integers(0, len(archive)))].genome
            s = int(rng.integers(0, len(g) - length))
            out.append(np.asarray(g[s:s + length]))
    return out


def test_synth_archive_matches_reference():
    a = genome.synth_archive(5, genome_len=3000, seed=11)
    b = j_genome.synth_archive(5, genome_len=3000, seed=11)
    for x, y in zip(a, b):
        assert x.file_id == y.file_id
        np.testing.assert_array_equal(x.genome, y.genome)
        np.testing.assert_array_equal(x.reads(100, 3), y.reads(100, 3))
    np.testing.assert_array_equal(genome.window_reads(a[0].genome, 230, 31),
                                  j_genome.window_reads(b[0].genome, 230, 31))


def test_build_archive_matches_reference_engine(built):
    _, _, jeng, teng = built
    np.testing.assert_array_equal(teng.words.numpy().view(np.uint32),
                                  np.asarray(jeng.words))


def test_reference_snapshot_loads_in_port(built, tmp_path, rng):
    cfg, archive, jeng, _ = built
    j_store.save(jeng, str(tmp_path / "snap"))
    for verify in ("eager", "lazy", "off"):
        st = store.load(str(tmp_path / "snap"), device="cpu", verify=verify)
        assert store.check_verified(str(tmp_path / "snap"))
        assert st.meta == store.read_meta(str(tmp_path / "snap"))
        reads = np.stack([q[:100] for q in _queries(archive, rng, 12)
                          if len(q) >= 100])
        for theta in (1.0, 0.6):
            want = np.asarray(jeng.msmt(jnp.asarray(reads), theta=theta))
            got = state_mod.msmt(st, reads, theta=theta)
            np.testing.assert_array_equal(got.numpy(), want)


def test_port_snapshot_loads_in_reference(built, tmp_path):
    _, _, jeng, teng = built
    store.save(teng, str(tmp_path / "snap"))
    back = j_store.load(str(tmp_path / "snap"))
    np.testing.assert_array_equal(np.asarray(back.words[0]),
                                  np.asarray(jeng.words))
    assert json.load(open(tmp_path / "snap" / "manifest.json"))["version"] == 1


def test_from_numpy_carries_reference_state(built):
    _, _, jeng, teng = built
    st = jeng.state
    meta_json = j_store.meta_to_json(st.meta)
    carried = state_mod.from_numpy(meta_json, [np.asarray(w) for w in st.words],
                                   device="cpu")
    assert torch.equal(carried.words[0], teng.words)
    assert carried.meta == teng.state.meta
    assert store.meta_to_json(carried.meta) == meta_json


def test_bad_snapshots_are_rejected(built, tmp_path):
    _, _, jeng, _ = built
    d = str(tmp_path / "snap")
    j_store.save(jeng, d)
    man = os.path.join(d, "manifest.json")
    good = json.load(open(man))
    with pytest.raises(store.SnapshotError):
        store.load(str(tmp_path / "missing"), device="cpu")
    for bad in ({**good, "format": "other"}, {**good, "version": 2}):
        json.dump(bad, open(man, "w"))
        with pytest.raises(store.SnapshotError):
            store.load(d, device="cpu")
    json.dump(good, open(man, "w"))
    arr = np.load(os.path.join(d, "words_0.npy"))
    arr[0, 0] ^= 1
    np.save(os.path.join(d, "words_0.npy"), arr)
    with pytest.raises(store.SnapshotError):
        store.load(d, device="cpu")
    store.load(d, device="cpu", verify="off")      # specs still match
    store.load(d, device="cpu", verify="lazy")
    with pytest.raises(store.SnapshotError):
        store.check_verified(d)


@pytest.mark.parametrize("theta", [1.0, 0.6, 0.25])
@pytest.mark.parametrize("backend", ["idl_probe", "torch"])
def test_service_matches_reference_service(built, theta, backend):
    _, archive, jeng, teng = built
    queries = _queries(archive, np.random.default_rng(int(theta * 100)), 11)
    jsvc = j_service.GeneSearchService(
        jeng, j_service.ServiceConfig(theta=theta, max_batch=4))
    tsvc = service.GeneSearchService(
        teng, service.ServiceConfig(theta=theta, max_batch=4,
                                    backend=backend))
    want = jsvc.search(queries)
    got = tsvc.search(queries)
    buckets = set()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.matches, np.asarray(b.matches))
        assert (a.file_ids, a.n_kmers, a.bucket) == \
            (b.file_ids, b.n_kmers, b.bucket)
        buckets.add(a.bucket)
    assert len(buckets) > 1                     # ragged reads, padded buckets
    assert tsvc.compile_counts() == {b: 1 for b in sorted(buckets)}
    assert tsvc.requests_served() == len(queries)
    assert 0 < tsvc.occupancy() < 1             # partial batches were padded
    # engine msmt on the unpadded reads agrees with the padded service
    direct = teng.msmt(queries[0][None], theta=theta, backend=backend)
    np.testing.assert_array_equal(direct.numpy()[0], got[0].matches)


def test_service_from_snapshot_and_admission(built, tmp_path):
    cfg, archive, jeng, _ = built
    j_store.save(jeng, str(tmp_path / "snap"))
    svc = service.GeneSearchService.from_snapshot(
        str(tmp_path / "snap"), service.ServiceConfig(max_batch=2),
        device="cpu")
    read = archive[5].reads(cfg.read_len, 1)[0]
    (res,) = svc.search([read])
    assert 5 in res.file_ids and res.matches.shape == (cfg.n_files,)
    with pytest.raises(ValueError):
        svc.submit(np.zeros((2, 50), np.uint8))          # one read per request
    with pytest.raises(ValueError):
        svc.submit(np.zeros(10, np.uint8))               # no 31-mers
    with pytest.raises(ValueError):
        service.ServiceConfig(backend="jnp")
    assert service.bucket_for(70) == j_service.bucket_for(70) == 128


def _run(module, args, pythonpath):
    env = dict(os.environ, PYTHONPATH=pythonpath, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module] + args,
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)


def test_launcher_recall_matches_reference():
    args = ["--files", "32", "--batch", "4", "--requests", "2"]
    port = _run("repro_torch.launch.serve", args + ["--device", "cpu"], SRC)
    ref = _run("repro.launch.serve", args, SRC)
    assert port.returncode == 0, port.stderr[-1500:]
    assert ref.returncode == 0, ref.stderr[-1500:]
    recall = re.search(r"recall \d+/\d+", port.stdout).group(0)
    assert recall == re.search(r"recall \d+/\d+", ref.stdout).group(0)
    assert recall == "recall 8/8"


@pytest.mark.parametrize("flags,line", [
    (["--files", "32", "--procs", "2"], "fabric: 2 worker processes"),
    pytest.param(["--files", "64", "--shards", "2"],
                 "2 shards over the 'files' axis", marks=pytest.mark.slow),
], ids=["procs", "shards"])
def test_launcher_fleet_recall_matches_reference(flags, line, tmp_path):
    """``--procs 2`` (a two-worker fabric) and ``--shards 2`` (a scatter
    router over two file shards) print the reference launcher's recall;
    ``--obs-dump`` writes the merged snapshot and its Chrome trace."""
    args = flags + ["--batch", "4", "--requests", "2"]
    dump = str(tmp_path / "obs.json")
    port = _run("repro_torch.launch.serve",
                args + ["--device", "cpu", "--obs-dump", dump], SRC)
    ref = _run("repro.launch.serve", args, SRC)
    assert port.returncode == 0, port.stderr[-1500:]
    assert ref.returncode == 0, ref.stderr[-1500:]
    assert line in port.stdout and line in ref.stdout
    recall = re.search(r"recall \d+/\d+", port.stdout).group(0)
    assert recall == re.search(r"recall \d+/\d+", ref.stdout).group(0)
    assert recall == "recall 8/8"
    assert "obs: " in port.stdout and os.path.exists(dump)
    assert os.path.getsize(dump) > 0


def test_port_imports_neither_jax_nor_reference():
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    code = ("import sys, importlib\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('clean', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr[-1500:]
    assert "clean" in p.stdout
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)"
                         r"|from repro\b(?!_torch))", re.M)
    sources = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(root, f)
        for root, _, files in os.walk(os.path.join(SRC, "repro_torch"))
        for f in files if f.endswith(".py")]
    for path in sources:
        assert not pattern.search(open(path).read()), path


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr and '"ok"' not in p.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    p = subprocess.run([sys.executable, str(alone)], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path)
    assert p.returncode != 0 and '"ok"' not in p.stdout
