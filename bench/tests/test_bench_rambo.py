"""The RAMBO adapter's reference and yardstick: the 64-bit locations, the
bucket assignment, the words a build sets and the service's answers equal
the port's plain (CPU) versions, and the byte counts are right on a
hand-worked case."""

import numpy as np
import pytest
import torch

from engines import rambo as adapter
from harness import counts, data
from reference import hashes64
from reference import rambo as ref_rambo

GEOMETRIES = [(1 << 18, 1 << 10, 4, 16), (1 << 20, 1 << 12, 3, 12),
              (1 << 27, 1 << 17, 4, 16), (3 << 18, 1 << 9, 4, 16)]


def config(scheme="idl", n_files=48, n_buckets=7, n_rep=4, m=1 << 18,
           L=1 << 10, eta=4, t=16, align=True):
    return {"n_files": n_files, "n_buckets": n_buckets, "n_rep": n_rep,
            "m": m, "k": 31, "t": t, "L": L, "eta": eta, "scheme": scheme,
            "minhash_mode": "doph", "align": align}


def archive(n_files=48, seed=5):
    return data.archive({"n_files": n_files, "file_bases": [300, 2500],
                         "repeat_fraction": 0.3, "repeat_unit": 100}, seed)


@pytest.mark.parametrize("scheme", ["idl", "rh"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("geo", GEOMETRIES, ids=str)
def test_locations_equal_the_port(scheme, align, geo):
    from repro_torch.core import idl
    from repro_torch.index import registry

    m, L, eta, t = geo
    codes = torch.as_tensor(np.random.default_rng(m + eta).integers(
        0, 4, size=(6, 260), dtype=np.uint8))
    cfg = idl.IDLConfig(k=31, t=t, L=L, eta=eta, m=m, align=align)
    g = hashes64.Geometry(k=31, t=t, L=L, eta=eta, m=m, scheme=scheme,
                          align=align)
    assert torch.equal(hashes64.locations(g, codes),
                       registry.locations(cfg, codes, scheme))


@pytest.mark.parametrize("shape", [(1024, 32, 10), (64, 8, 6), (5, 3, 2)])
def test_assignment_equals_the_port(shape):
    from repro_torch.index import engines

    assert np.array_equal(ref_rambo.assignment(*shape),
                          engines.rambo_assignment(*shape))


@pytest.mark.parametrize("scheme", ["idl", "rh"])
def test_words_and_verdicts_equal_the_port(scheme):
    """A build through the port's archive builder (on the CPU, its plain
    versions) sets exactly the reference's words, and the service's
    answers at theta 1 and 0.8 are the reference's verdicts."""
    from repro_torch.serving import service

    genomes = archive()
    cfg = config(scheme)
    index = adapter.build(adapter.new_index(cfg, "cpu"), genomes, 230, 64)
    words = adapter.reference_words(cfg, genomes, "cpu")
    assert torch.equal(words, adapter.output_words(index))
    reads, _ = data.read_pool(genomes, 1, 96, 230, 0.5, 1, 9, "cpu")
    reads = list(reads[0])
    for theta in (1.0, 0.8):
        svc = service.GeneSearchService(index, service.ServiceConfig(
            theta=theta, max_batch=32, backend="idl_probe"))
        got = np.stack([r.matches for r in svc.search(np.stack(reads))])
        want = adapter.reference_verdicts(cfg, words, reads, theta)
        assert (want == got).all()
        assert want.any(1).sum() >= 48          # the positives are found
    # reads of other lengths, one at a time through the engine
    for r in (genomes[3][:100], genomes[7][-31:]):
        got = index.msmt(torch.as_tensor(r[None]), 1.0)[0].numpy()
        assert (adapter.reference_verdicts(cfg, words, [r], 1.0)[0]
                == got).all()


def test_control_breaks_the_guarantees():
    genomes = archive()
    cfg = config()
    words = adapter.reference_words(cfg, genomes, "cpu")
    cut = adapter.reference_words(cfg, genomes, "cpu", skip_last_kmer=True)
    assert int((words != cut).sum()) > 0
    # a read whose only changed kmer is its first one matches under the
    # control's threshold and not under theta 1
    read = genomes[0][:230].copy()
    read[0] = (read[0] + 1) % 4
    strict = adapter.reference_verdicts(cfg, words, [read], 1.0)
    loose = adapter.reference_verdicts(cfg, words, [read], 1.0, slack=1)
    assert not strict[0, 0] and loose[0, 0]


def test_reference_in_blocks_as_at_once():
    genomes = archive(n_files=12)
    cfg = config(n_files=12, n_buckets=4, n_rep=3)
    g = adapter.geometry(cfg)
    whole = ref_rambo.build_words(g, 12, 4, 3, genomes, "cpu")
    assert torch.equal(whole, ref_rambo.build_words(g, 12, 4, 3, genomes,
                                                    "cpu", chunk=777))
    reads, _ = data.read_pool(genomes, 1, 40, 230, 0.5, 1, 2, "cpu")
    reads = list(reads[0])
    assert (ref_rambo.verdicts(g, whole, reads, 0.8, 12, 4, 3, block=7)
            == ref_rambo.verdicts(g, whole, reads, 0.8, 12, 4, 3)).all()


def test_probe_and_insert_bytes_hand_worked(monkeypatch):
    # 2 files, 2 buckets, 2 repetitions, 2^12-bit filters (128 words):
    # the transposed copy is (128, 4), a 16-byte row; the words (4, 128)
    cfg = config(scheme="rh", n_files=2, n_buckets=2, n_rep=2, m=1 << 12,
                 L=1 << 8, eta=2)
    # two reads of one kmer each; their bit locations fixed by hand
    locs = torch.tensor([[[10], [70]], [[20], [300]]])
    monkeypatch.setattr(hashes64, "locations", lambda g_, codes: locs)
    monkeypatch.setattr(ref_rambo, "assignment",
                        lambda n, b, r: np.array([[0, 1], [1, 1]]))
    reads = np.zeros((2, 31), dtype=np.uint8)
    # rows 10 >> 5 = 0 (twice), 70 >> 5 = 2, 300 >> 5 = 9: three 16-byte
    # rows, each in a sector of its own; 2 kmers x 4 int32 answers out
    assert adapter.probe_bytes_each(cfg, reads[None], "cpu") == \
        [3 * 32 + 2 * 4 * 4]
    # read 0 (file 0) lands in filters 0 (r 0) and 3 (r 1), read 1 (file
    # 1) in filters 1 and 3: words 0, 2 of filters 0 and 3 (0, 2, 384,
    # 386), 0, 9 of filters 1 and 3 (128, 137, 384, 393): sectors 0, 48,
    # 16, 17, 49
    fids = np.array([0, 1])
    assert adapter.insert_bytes(cfg, reads, fids, "cpu") == 2 * 32 * 5


@pytest.mark.parametrize("n_buckets", [4, 5])
def test_probe_bytes_of_many_batches_as_of_each(n_buckets):
    # R·B 8: rows of whole sectors, counted; R·B 10: rows that straddle
    # sectors, whose sectors are counted
    genomes = archive(n_files=12)
    cfg = config(n_files=12, n_buckets=n_buckets, n_rep=2)
    g, rb = adapter.geometry(cfg), 2 * n_buckets
    batches, _ = data.read_pool(genomes, 5, 8, 230, 0.5, 1, 4, "cpu")
    want = [counts.sector_bytes(torch.unique(hashes64.locations(
        g, torch.as_tensor(b)) >> 5).numpy() * rb, rb) + 4 * 8 * 200 * rb
        for b in batches]
    assert adapter.probe_bytes_each(cfg, batches, "cpu", chunk=2) == want
    assert adapter.probe_bytes_each(cfg, batches, "cpu") == want


def test_insert_batches_are_the_archive_builders(monkeypatch):
    """The insert yardstick counts the batches the program inserts."""
    from repro_torch.index import engines

    genomes = archive(n_files=12)
    cfg = config(n_files=12, n_buckets=4, n_rep=3)
    seen = []
    insert = engines.RamboIndex.insert_batch

    def record(self, reads, file_ids=None, **kw):
        seen.append((np.asarray(reads), np.asarray(file_ids)))
        return insert(self, reads, file_ids, **kw)

    monkeypatch.setattr(engines.RamboIndex, "insert_batch", record)
    adapter.build(adapter.new_index(cfg, "cpu"), genomes, 230, 64)
    want = adapter.insert_batches(cfg, genomes, 230, 64)
    assert len(seen) == len(want)
    for (r, f), (wr, wf) in zip(seen, want):
        assert (r == wr).all() and (f == wf).all()
