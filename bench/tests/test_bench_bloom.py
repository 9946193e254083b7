"""The flat filter's adapter, reference and yardstick: the adapter keeps
the contract, the reference's locations, words and verdicts equal the
port's plain (CPU) versions and its served answers (one file's column),
the control is caught, and the byte counts are right on a hand-worked
case."""

import numpy as np
import pytest
import torch

from engines import bloom as adapter
from harness import counts, data
from reference import bloom as ref_bloom
from reference import hashes64


def config(scheme="idl", m=1 << 20, L=1 << 10, eta=4, t=16, align=True):
    return {"n_files": 24, "m": m, "k": 31, "t": t, "L": L, "eta": eta,
            "scheme": scheme, "minhash_mode": "doph", "align": align}


def archive(n_files=24, seed=5):
    return data.archive({"n_files": n_files, "file_bases": [300, 2500],
                         "repeat_fraction": 0.3, "repeat_unit": 100}, seed)


def test_adapter_keeps_the_contract():
    """``test_bench_run`` holds every adapter to the table's signatures;
    here what the flat filter's functions return: an empty index of
    ``m / 32`` words, one file's column of verdicts, a size per batch."""
    genomes = archive(n_files=4)
    cfg = config()
    index = adapter.new_index(cfg, "cpu")
    assert adapter.output_words(index).shape == (1 << 15,)
    assert not adapter.output_words(index).any()
    words = adapter.reference_words(cfg, genomes, "cpu")
    assert words.shape == (1 << 15,) and words.dtype == torch.int32
    reads = [genomes[0][:230], genomes[1][:64]]
    assert adapter.reference_verdicts(cfg, words, reads, 1.0).shape == (2, 1)
    batches = np.stack([np.stack([genomes[0][:230]] * 3)] * 2)
    assert len(adapter.probe_bytes_each(cfg, batches, "cpu")) == 2


@pytest.mark.parametrize("scheme", ["idl", "rh"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("geo", [(1 << 18, 1 << 10, 4, 16),
                                 (3 << 18, 1 << 9, 3, 12),
                                 (1 << 32, 1 << 13, 4, 16)], ids=str)
def test_locations_equal_hashes64_and_the_port(scheme, align, geo):
    """Up to 2**32 bits the flat filter's locations are the 64-bit path's
    of every other cell, and the port's."""
    from repro_torch.core import idl
    from repro_torch.index import registry

    m, L, eta, t = geo
    codes = torch.as_tensor(np.random.default_rng(m + eta).integers(
        0, 4, size=(6, 260), dtype=np.uint8))
    g = ref_bloom.Geometry(k=31, t=t, L=L, eta=eta, m=m, scheme=scheme,
                           align=align)
    got = ref_bloom.locations(g, codes)
    assert torch.equal(got, hashes64.locations(hashes64.Geometry(
        k=31, t=t, L=L, eta=eta, m=m, scheme=scheme, align=align), codes))
    assert torch.equal(got, registry.locations(idl.IDLConfig(
        k=31, t=t, L=L, eta=eta, m=m, align=align), codes, scheme))


def test_locations_past_2_32_bits():
    """At the configuration's 2**35 bits the locations equal the port's and
    each repetition lands in its own part, past 2**32 for three of four."""
    from repro_torch.core import idl
    from repro_torch.index import registry

    m = 1 << 35
    codes = torch.as_tensor(np.random.default_rng(3).integers(
        0, 4, size=(8, 230), dtype=np.uint8))
    got = ref_bloom.locations(ref_bloom.Geometry(
        k=31, t=16, L=1 << 13, eta=4, m=m, scheme="idl"), codes)
    assert torch.equal(got, registry.locations(idl.IDLConfig(
        k=31, t=16, L=1 << 13, eta=4, m=m), codes, "idl"))
    part = got // (m // 4)
    assert torch.equal(part, torch.arange(4)[None, :, None].expand_as(part))
    assert int(got.max()) >= 1 << 34
    # a range past 2**32 bits is refused (the random hash's part here)
    with pytest.raises(ValueError, match="exceeds 2"):
        ref_bloom.Geometry(k=31, t=16, L=1 << 13, eta=4, m=m, scheme="rh")


@pytest.mark.parametrize("scheme", ["idl", "rh"])
def test_words_and_verdicts_equal_the_port(scheme):
    """A build through the port's archive builder (on the CPU, its plain
    versions) sets exactly the reference's words, and the service's
    answers, one file's column, are the reference's verdicts at theta 1
    and 0.8."""
    from repro_torch.serving import service

    genomes = archive()
    cfg = config(scheme)
    index = adapter.build(adapter.new_index(cfg, "cpu"), genomes, 230, 64)
    words = adapter.reference_words(cfg, genomes, "cpu")
    assert torch.equal(words, adapter.output_words(index))
    reads, sources = data.read_pool(genomes, 1, 96, 230, 0.5, 1, 9, "cpu")
    reads = list(reads[0])
    for theta in (1.0, 0.8):
        svc = service.GeneSearchService(index, service.ServiceConfig(
            theta=theta, max_batch=32, backend="idl_probe"))
        results = svc.search(np.stack(reads))
        got = np.stack([r.matches for r in results])
        want = adapter.reference_verdicts(cfg, words, reads, theta)
        assert got.shape == want.shape == (96, 1)
        assert (want == got).all()
        assert [r.file_ids for r in results] == [(0,) if v else ()
                                                 for v in want[:, 0]]
        assert want[sources[0] >= 0].all()      # no false negatives
    # the poisoned reads are not all flagged at theta 1
    assert not adapter.reference_verdicts(cfg, words, reads, 1.0)[
        sources[0] < 0].all()
    # reads of other lengths, one at a time through the engine
    for r in (genomes[3][:100], genomes[7][-31:]):
        got = index.msmt(torch.as_tensor(r[None]), 1.0).numpy()
        assert (adapter.reference_verdicts(cfg, words, [r], 1.0)
                == got).all()


def test_control_breaks_the_guarantees():
    genomes = archive()
    cfg = config()
    words = adapter.reference_words(cfg, genomes, "cpu")
    cut = adapter.reference_words(cfg, genomes, "cpu", skip_last_kmer=True)
    assert int((words != cut).sum()) > 0
    # a read whose only changed kmer is its first one is flagged under the
    # control's threshold and not under theta 1
    read = genomes[0][:230].copy()
    read[0] = (read[0] + 1) % 4
    strict = adapter.reference_verdicts(cfg, words, [read], 1.0)
    loose = adapter.reference_verdicts(cfg, words, [read], 1.0, slack=1)
    assert not strict[0, 0] and loose[0, 0]


def test_reference_in_blocks_as_at_once():
    genomes = archive(n_files=12)
    g = adapter.geometry(config())
    whole = ref_bloom.build_words(g, genomes, "cpu")
    assert torch.equal(whole, ref_bloom.build_words(g, genomes, "cpu",
                                                    chunk=777))
    reads, _ = data.read_pool(genomes, 1, 40, 230, 0.5, 1, 2, "cpu")
    reads = list(reads[0])
    assert (ref_bloom.verdicts(g, whole, reads, 0.8, block=7)
            == ref_bloom.verdicts(g, whole, reads, 0.8)).all()


def test_check_program_refuses_what_cannot_serve_the_filter(monkeypatch):
    """A program whose locations wrap mod 2**32, or whose flat filter
    answers a bool a read, is refused before anything is built."""
    from repro_torch.index import registry, state

    cfg = config(m=1 << 35, L=1 << 13)
    adapter.check_program(cfg)
    locations = registry.locations
    monkeypatch.setattr(registry, "locations",
                        lambda c, codes, s: locations(c, codes, s)
                        & 0xFFFFFFFF)
    with pytest.raises(RuntimeError, match="cannot address"):
        adapter.new_index(cfg, "cpu")
    monkeypatch.setattr(registry, "locations", locations)
    verdicts = state.verdicts
    monkeypatch.setattr(state, "verdicts",
                        lambda *a, **kw: verdicts(*a, **kw)[:, 0])
    with pytest.raises(RuntimeError, match="one file's column"):
        adapter.check_program(cfg)


def test_probe_and_insert_bytes_hand_worked(monkeypatch):
    cfg = config(m=1 << 12, L=1 << 8, eta=2)
    # two reads of one kmer each; their bit locations fixed by hand
    locs = torch.tensor([[[10], [70]], [[20], [3000]]])
    monkeypatch.setattr(ref_bloom, "locations", lambda g_, codes: locs)
    reads = np.zeros((2, 31), dtype=np.uint8)
    # words 10 >> 5 = 0 (twice), 70 >> 5 = 2, 3000 >> 5 = 93: sectors 0
    # (words 0 and 2) and 11 (word 93); two int32 answers out
    assert adapter.probe_bytes_each(cfg, reads[None], "cpu") == \
        [2 * 32 + 2 * 4]
    assert adapter.insert_bytes(cfg, reads, np.array([0, 1]), "cpu") == \
        2 * 32 * 2


def test_probe_bytes_of_many_batches_as_counts_sector_bytes():
    genomes = archive(n_files=12)
    cfg = config()
    g = adapter.geometry(cfg)
    batches, _ = data.read_pool(genomes, 5, 8, 230, 0.5, 1, 4, "cpu")
    want = [counts.sector_bytes(ref_bloom.locations(
        g, torch.as_tensor(b)).numpy() >> 5, 1) + 4 * 8 * 200
        for b in batches]
    assert adapter.probe_bytes_each(cfg, batches, "cpu", chunk=2) == want
    assert adapter.probe_bytes_each(cfg, batches, "cpu") == want


def test_insert_batches_are_the_archive_builders(monkeypatch):
    """The insert yardstick counts the batches the program inserts."""
    from repro_torch.index import engines

    genomes = archive(n_files=12)
    cfg = config()
    seen = []
    insert = engines.PackedBloomIndex.insert_batch

    def record(self, reads, file_ids=None, **kw):
        seen.append(np.asarray(reads))
        return insert(self, reads, file_ids, **kw)

    monkeypatch.setattr(engines.PackedBloomIndex, "insert_batch", record)
    adapter.build(adapter.new_index(cfg, "cpu"), genomes, 230, 64)
    want = adapter.insert_batches(cfg, genomes, 230, 64)
    assert len(seen) == len(want)
    for r, (wr, _) in zip(seen, want):
        assert (r == wr).all()
