"""The reference and the yardstick: the reference's locations, index words
and verdicts equal the port's plain (CPU) versions, and the byte counts
are right on hand-worked cases."""

import numpy as np
import pytest
import torch

from harness import counts, data
from reference import hashes
from reference import index as ref_index

GEOMETRIES = [(1 << 18, 1 << 10, 4, 16), (1 << 20, 1 << 12, 3, 12),
              (1 << 26, 1 << 17, 4, 16), (3 << 18, 1 << 9, 4, 16)]


def port_config(m, L, eta, t, align=True):
    from repro_torch.core import idl

    return idl.IDLConfig(k=31, t=t, L=L, eta=eta, m=m, align=align)


@pytest.mark.parametrize("scheme", ["idl", "rh"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("geo", GEOMETRIES, ids=str)
def test_locations_equal_the_port(scheme, align, geo):
    from repro_torch.kernels.idl_locations import ref as port_ref

    m, L, eta, t = geo
    codes = torch.as_tensor(np.random.default_rng(m + eta).integers(
        0, 4, size=(6, 260), dtype=np.uint8))
    want = (port_ref.idl_locations32_ref if scheme == "idl"
            else port_ref.rh_locations32_ref)(
        port_config(m, L, eta, t, align), codes)
    g = hashes.Geometry(k=31, t=t, L=L, eta=eta, m=m, scheme=scheme,
                        align=align)
    assert torch.equal(hashes.locations(g, codes), want)


def archive(n_files=48, seed=5):
    config = {"n_files": n_files, "file_bases": [300, 2500],
              "repeat_fraction": 0.3, "repeat_unit": 100}
    return data.archive(config, seed)


@pytest.mark.parametrize("scheme", ["idl", "rh"])
def test_index_and_verdicts_equal_the_port(scheme):
    """A build through the port's archive builder (on the CPU, its plain
    versions) sets exactly the reference's words, and the port's MSMT at
    theta 1 and 0.8 gives the reference's verdicts."""
    from repro_torch.index import engines, ingest

    genomes = archive()
    cfg = port_config(1 << 18, 1 << 10, 4, 16)
    eng = engines.BitSlicedIndex.build(cfg, scheme, n_files=len(genomes),
                                       device="cpu")
    eng = ingest.build_archive(eng, list(enumerate(genomes)), read_len=230,
                               chunk_reads=64)
    g = hashes.Geometry(k=31, t=16, L=1 << 10, eta=4, m=1 << 18,
                        scheme=scheme)
    words = ref_index.build_words(g, len(genomes), genomes, "cpu",
                                  chunk=3000)
    assert torch.equal(words, eng.words)
    reads, _ = data.read_pool(genomes, 1, 96, 230, 0.5, 1, 9, "cpu")
    reads = list(reads[0]) + [genomes[3][:100], genomes[7][-31:]]
    for theta in (1.0, 0.8):
        want = ref_index.verdicts(g, words, reads, theta, len(genomes))
        got = np.stack([eng.msmt(torch.as_tensor(r[None]), theta,
                                 backend="torch")[0].numpy() for r in reads])
        assert (want == got).all()
    assert want.any(1).sum() >= 48          # the positives are found


def test_control_breaks_the_guarantees():
    genomes = archive()
    g = hashes.Geometry(k=31, t=16, L=1 << 10, eta=4, m=1 << 18,
                        scheme="idl")
    words = ref_index.build_words(g, len(genomes), genomes, "cpu")
    cut = ref_index.build_words(g, len(genomes), genomes, "cpu",
                                skip_last_kmer=True)
    assert int((words != cut).sum()) > 0
    # a read whose only changed kmer is its first one matches under the
    # control's threshold and not under theta 1
    read = genomes[0][:230].copy()
    read[0] = (read[0] + 1) % 4
    strict = ref_index.verdicts(g, words, [read], 1.0, len(genomes))
    loose = ref_index.verdicts(g, words, [read], 1.0, len(genomes), slack=1)
    assert not strict[0, 0] and loose[0, 0]


def test_sector_bytes_hand_worked():
    # words 0-7 are one sector, 8-15 the next
    assert counts.sector_bytes([0], 1) == 32
    assert counts.sector_bytes([0, 3, 7], 1) == 32
    assert counts.sector_bytes([0, 8, 9, 100], 1) == 3 * 32
    assert counts.sector_bytes([0, 32], 32) == 2 * 4 * 32     # aligned rows
    assert counts.sector_bytes([4], 8) == 2 * 32              # straddles two


def test_probe_and_insert_bytes_hand_worked(monkeypatch):
    g = hashes.Geometry(k=31, t=16, L=1 << 10, eta=2, m=1 << 18,
                        scheme="rh")
    # two reads of one kmer each; their locations fixed by hand
    locs = torch.tensor([[[10], [70]], [[10], [300]]])
    monkeypatch.setattr(hashes, "locations", lambda g_, codes: locs)
    reads = np.zeros((2, 31), dtype=np.uint8)
    # rows 10, 70, 300 read once (one 4-word row = half a sector each,
    # 16 B rows: 10 and 11 would share a sector), 2 kmers x 4 words out
    assert counts.probe_bytes(g, 4, reads, "cpu") == 3 * 32 + 4 * 2 * 4
    # file 5 (word 0) and file 40 (word 1) of 2-word rows: words 20, 140
    # for read 0, 21, 601 for read 1: sectors 2, 17, 2, 75
    fids = np.array([5, 40])
    assert counts.insert_bytes(g, 2, reads, fids, "cpu") == 2 * 32 * 3


@pytest.mark.parametrize("row_words", [4, 32])
def test_probe_bytes_of_many_batches_as_of_each(row_words):
    genomes = archive(n_files=12)
    g = hashes.Geometry(k=31, t=16, L=1 << 10, eta=4, m=1 << 18,
                        scheme="idl")
    batches, _ = data.read_pool(genomes, 5, 8, 230, 0.5, 1, 4, "cpu")
    want = [counts.probe_bytes(g, row_words, b, "cpu") for b in batches]
    assert counts.probe_bytes_each(g, row_words, batches, "cpu",
                                   chunk=2) == want


def test_window_count_and_batches():
    genomes = archive(n_files=12)
    for n in (31, 100, 230, 231, 429, 430, 431, 5000):
        codes = np.zeros(n, dtype=np.uint8)
        assert counts.window_count(n, 230, 31) == \
            len(counts.window_reads(codes, 230, 31))
    batches = counts.build_batches(genomes, 230, 31, 64)
    total = sum(counts.window_count(len(x), 230, 31) for x in genomes)
    assert len(batches) == -(-total // 64)
    assert all(r.shape == (64, 230) and f.shape == (64,) for r, f in batches)


def test_build_batches_are_the_archive_builders(monkeypatch):
    """The insert yardstick counts the batches the program inserts."""
    from repro_torch.index import engines, ingest

    genomes = archive(n_files=12)
    seen = []
    insert = engines.BitSlicedIndex.insert_batch

    def record(self, reads, file_ids=None, **kw):
        seen.append((np.asarray(reads), np.asarray(file_ids)))
        return insert(self, reads, file_ids, **kw)

    monkeypatch.setattr(engines.BitSlicedIndex, "insert_batch", record)
    eng = engines.BitSlicedIndex.build(port_config(1 << 18, 1 << 10, 4, 16),
                                       "idl", n_files=12, device="cpu")
    ingest.build_archive(eng, list(enumerate(genomes)), read_len=230,
                         chunk_reads=64)
    want = counts.build_batches(genomes, 230, 31, 64)
    assert len(seen) == len(want)
    for (r, f), (wr, wf) in zip(seen, want):
        assert (r == wr).all() and (f == wf).all()
