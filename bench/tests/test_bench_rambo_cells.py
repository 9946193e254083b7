"""The ``rambo-idl`` cell: its configuration resolves to the program's
``RamboIndex`` through the ``rambo`` adapter, the query cell reports its
end-to-end metric and no build cell is declared, and the two merge readers read what a run of the
cell records (and nothing where a run has none), as does the count of
transposed copies built in the window."""

import importlib

import pytest

from harness import spec
from harness.devtrace import DeviceTrace
from harness.record import Record

QUERY, BUILD = "rambo-idl.query", "rambo-idl.build"
MERGE_READERS = ("planner.merge_ms.query", "kernels.merge_ms.query")
COPIES = "planner.transposed_copies.query"

# device operations of two query batches, as the profiler names them
# (torch 2.11 on an H100): R = 10 merge gathers of 0.2 ms a batch, and the
# cell's other work
GATHER = ("void at::native::index_elementwise_kernel<128, 4, "
          "at::native::gpu_index_kernel<at::native::index_kernel_impl<"
          "at::native::OpaqueType<1> > >(at::TensorIteratorBase&)")
OTHERS = ("void (anonymous namespace)::gather_and_kernel<int4, true>("
          "int4 const*, long long const*, int4*, long long)",
          "void at::native::tensor_kernel_scan_innermost_dim_with_indices<"
          "long, std::greater_equal<long> >(long*, long*, long const*)",
          "void at::native::vectorized_elementwise_kernel<4, "
          "at::native::BinaryFunctor<bool, bool, bool, "
          "at::native::bitwise_and_kernel_cuda>(int, bool*, bool const*)",
          "void at::native::reduce_kernel<512, 1>(long*)",
          # an index gather of 8-byte elements, as the build's plan runs
          GATHER.replace("OpaqueType<1>", "OpaqueType<8>"))


def batch_events(t0: int) -> list:
    """One batch's operations from ``t0`` ns: the others 1 ms each, then
    the 10 gathers, 0.2 ms each."""
    events, t = [], t0
    for name in OTHERS:
        events.append((name, t, t + 1_000_000))
        t += 1_000_000
    for _ in range(10):
        events.append((GATHER, t, t + 200_000))
        t += 200_000
    return events


def record(*, events=None, hists=None, counters=None, batches=2) -> Record:
    device = None
    if events is not None:
        device = DeviceTrace()
        device.events, device.t0_ns, device.t1_ns = events, 0, 10**9
    return Record(setup_s=1.0, window_s=1.0, peak_bytes=0,
                  outcome={"batches": batches, "reads": 256 * batches},
                  obs={"counters": counters or {}, "hists": hists or {}},
                  spans=[],
                  device=device, work={})


def stage(op: str, name: str, count: int, total: float) -> tuple:
    return (f"op={op},stage={name},tier=planner",
            {"count": count, "sum": total})


def test_kernel_merge_reader_reads_the_gathers_alone():
    events = batch_events(0) + batch_events(10_000_000)
    got = spec.load_reader("kernels.merge_ms.query")(record(events=events))
    assert got == pytest.approx(2.0)                    # 10 x 0.2 ms


def test_planner_merge_reader_reads_the_merge_stage_alone():
    hists = {"planner.stage_ms": dict([
        stage("query", "merge", 4, 1.0),
        stage("query", "launch", 4, 100.0),
        stage("query", "transpose", 1, 50.0),
        stage("insert", "merge", 4, 30.0)])}
    got = spec.load_reader("planner.merge_ms.query")(record(hists=hists))
    assert got == pytest.approx(0.25)


@pytest.mark.parametrize("case", ["no trace", "no sample", "no batch"])
@pytest.mark.parametrize("reader", MERGE_READERS)
def test_merge_readers_read_nothing_where_a_run_has_none(reader, case):
    """A run without the profiler, a run of a program that records no
    merge (the bit-sliced cells, or a parent without the stage), a window
    that sent no batch: no reading, and no error."""
    if case == "no trace":
        rec = record(hists={"planner.stage_ms": dict(
            [stage("query", "launch", 4, 1.0)])})
    elif case == "no sample":
        rec = record(events=[(OTHERS[0], 0, 1000)], hists={
            "planner.stage_ms": dict([stage("query", "merge", 0, 0.0),
                                      stage("query", "launch", 4, 1.0)])})
    else:
        rec = record(events=[], hists={}, batches=0)
    assert spec.load_reader(reader)(rec) is None


@pytest.mark.parametrize("copies", [0.0, 1.0, 2.0])
def test_copies_reader_reads_the_rambo_series_alone(copies):
    counters = {"index.transposed_copies": {"engine=rambo": copies,
                                            "engine=other": 5.0},
                "index.transposed_bytes": {"engine=rambo": 5.0 * 2**30}}
    got = spec.load_reader(COPIES)(record(counters=counters))
    assert got == copies


@pytest.mark.parametrize("counters", [
    {}, {"index.transposed_copies": {}},
    {"index.transposed_copies": {"engine=other": 1.0}}])
def test_copies_reader_reads_nothing_without_the_counter(counters):
    """A program that counts no copy (the parent of the counter) or no
    RAMBO index: no reading, and no error."""
    assert spec.load_reader(COPIES)(record(counters=counters)) is None


def test_config_resolves_to_rambo():
    from repro_torch.index import engines

    cell = spec.load_cell(QUERY)
    config = cell.config
    adapter = importlib.import_module(f"engines.{config['engine']}")
    assert adapter.__name__ == "engines.rambo"
    index = adapter.new_index(config, "meta")
    assert isinstance(index, engines.RamboIndex)
    assert (index.n_buckets, index.n_rep) == engines.rambo_dimensions(
        config["n_files"]) == (32, 10)
    assert tuple(index.words.shape) == (320, 2**22)
    # the window of the IDL paper's RAMBO experiment, in bits of a filter
    assert index.cfg.L == config["L"] == 2**12
    # every flat word index fits 31 bits, and twice the filter would not
    assert index.words.numel() < 2**31 <= 2 * index.words.numel()
    assert set(config["guarantees"]) == {"no_false_negatives",
                                         "exact_verdicts"}
    assert set(config["reduced"]) == {"file_bases"}


@pytest.mark.parametrize("name,metric", [(QUERY, "query_reads_per_s")])
def test_cells_report_their_end_to_end_metric(name, metric):
    cell = spec.load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {metric, "peak_mem_gib", "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    assert layer and all(m["moves"] == metric for m in cell.per_layer)
    assert set(MERGE_READERS) | {COPIES} <= layer
    assert cell.mix == spec.load_json(spec.traffic_path(name.split(".")[1]))


def test_no_build_cell_is_declared():
    """The build cell's rate spreads wider between runs than its bound
    admits, so the configuration has the query cell alone: no entry of
    the benchmark names the build cell."""
    bench = spec.load_json(spec.SPEC_FILE)
    names = {w["name"] for w in bench["workloads"]}
    assert QUERY in names and BUILD not in names
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert BUILD not in metric.get("workloads", [])
