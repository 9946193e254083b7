"""The port's dry run and roofline, on the CPU.

* The counterparts of ``tests/test_dryrun_integration.py``'s three cells,
  each through ``python -m repro_torch.launch.dryrun`` in a subprocess
  with its own timeout: ``sasrec serve_p99`` on the single-pod mesh (256
  devices), ``fm serve_p99`` on the multi-pod mesh (512), and
  ``granite-20b long_500k`` recorded as skipped. Each ``ok`` record is
  counted on the sharded step's local shards (``count_split: "local
  shards"``), with a numeric ``coll_bytes_per_chip`` over the reference's
  five kinds and ``count``, and ``memory_stats`` holding argument, output
  and temp bytes; beside it, the unsharded count split evenly.
* ``run_cell`` in this process for ``granite-moe-1b-a400m train_4k`` cut
  to 2 layers: collectives counted, the fake group gone after.
* ``Roofline``'s terms at the H100's constants (the counterpart of
  ``tests/test_substrates.py::test_roofline_terms``).
* Each LM and recsys cell's counted FLOPs (``FlopCounterMode`` over the
  step on meta tensors) against its ``model_flops``, within these stated
  factors (measured on this tree in brackets):
  - LM ``train_4k`` and ``prefill_32k``: 1.0-2.0. Remat recomputes every
    layer's forward (8 N D against 6 N D), and MoE experts run their
    capacity slots, 1.25 x the routed tokens [1.12-1.78];
  - LM ``decode_32k``, dense archs: 0.95-1.05 [0.985-0.993];
  - LM ``decode_32k``, MoE archs: 1.0-40. At 128 tokens an expert still
    runs its floor of 8 capacity slots in each dispatch group: arctic's
    128 experts x 32 groups x 8 slots against 256 routed choices
    [granite-moe 2.04, arctic 30.0];
  - recsys: 0.95-1.3. The two-tower step recomputes its checkpointed
    logit blocks; MIND's model_flops rounds its routing [0.957-1.263].
  The same cells counted on the sharded step's local shards at 256
  devices (LM cells cut to 1 layer): one device's FLOPs times the chips
  equal the unsharded count up to ``REPLICATION``, where a cell repeats
  work over an axis, and never under it. At full depth (``dryrun --all``)
  every LM, FM, two-tower and MIND cell but MIND's ``retrieval_cand``
  stays inside the factors above; SASRec's cells and MIND's retrieval
  exceed them by their replication.
* The fake process group never outlives a cell.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORS = {("lm", "train"): (1.0, 2.0), ("lm", "prefill"): (1.0, 2.0),
           ("lm", "decode"): (0.95, 1.05), ("lm-moe", "decode"): (1.0, 40.0),
           ("recsys", None): (0.95, 1.3)}


@pytest.fixture(autouse=True)
def no_process_group_left():
    """Every test ends with no default process group in this process."""
    yield
    assert not dist.is_initialized()


def _run_cell(arch, shape, mesh, tmp_path):
    pytest.importorskip(
        "torch.testing._internal.distributed.fake_pg",
        reason=f"torch {torch.__version__} has no fake process group")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", arch, "--shape", shape, "--mesh", mesh,
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(tmp_path / f"{arch}__{shape}__{mesh}.json") as f:
        return json.load(f)


def _check_ok(rec, chips):
    assert rec["status"] == "ok"
    assert rec["chips"] == chips
    assert rec["flops_per_chip"] > 0
    assert rec["bytes_per_chip"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    mem = rec["memory_stats"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["output_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] >= 0
    assert rec["count_split"] == "local shards"
    coll = rec["coll_breakdown"]
    assert set(coll) == set(dryrun.COLL_KINDS) | {"count"}
    assert rec["coll_bytes_per_chip"] == sum(
        v for k, v in coll.items() if k != "count")
    assert rec["t_collective"] == pytest.approx(
        rec["coll_bytes_per_chip"] / analysis.NVLINK_BW)
    assert "LocalCounter" in rec["coll_source"]
    assert "FlopCounterMode" in rec["count_source"]
    assert set(rec["even_split"]) == {"flops_per_chip", "bytes_per_chip"}


def test_dryrun_cell_single_pod(tmp_path):
    rec = _run_cell("sasrec", "serve_p99", "single", tmp_path)
    _check_ok(rec, 256)
    spec = configs.get("sasrec")
    cell = spec.shapes["serve_p99"]
    mf = spec.model_flops_fn(spec.make_config(), cell)
    # the unsharded count is the model's FLOPs; a device's shards hold at
    # least their share of them (its one attention head repeats over
    # 'model')
    assert rec["even_split"]["flops_per_chip"] * 256 == pytest.approx(
        mf, rel=1e-6)
    assert rec["flops_per_chip"] * 256 >= mf * (1 - 1e-9)
    assert rec["coll_breakdown"]["count"] > 0


def test_dryrun_cell_multi_pod(tmp_path):
    rec = _run_cell("fm", "serve_p99", "multi", tmp_path)
    _check_ok(rec, 512)
    # FM's forward has no matrix product: its FLOPs are its model_flops
    assert "model_flops" in rec["count_source"]
    assert rec["useful_flops_fraction"] == pytest.approx(1.0)
    # its row-sharded tables' partial rows are reduced across 'model'
    assert rec["coll_bytes_per_chip"] > 0


def test_dryrun_skip_recorded(tmp_path):
    rec = _run_cell("granite-20b", "long_500k", "single", tmp_path)
    assert rec["status"] == "skipped"
    assert "full-attention" in rec["skip_reason"]


def test_genesearch_cell_counts_from_shapes(tmp_path):
    """The gene-search serve step cannot run on meta: its record says its
    counts come from its shapes; the memory term is the row gather's."""
    pytest.importorskip(
        "torch.testing._internal.distributed.fake_pg",
        reason=f"torch {torch.__version__} has no fake process group")
    rec = dryrun.run_cell("idl-genesearch", "serve_p99", "single",
                          str(tmp_path))
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["count_source"].startswith("shapes")
    assert rec["count_split"] == "even"
    assert rec["coll_bytes_per_chip"] is None and rec["t_collective"] is None
    cfg = configs.get("idl-genesearch").make_config()
    cell = configs.get("idl-genesearch").shapes["serve_p99"]
    assert rec["bytes_per_chip"] * 256 == dryrun.gather_bytes(cfg, cell)
    # the index's file slice over 'model' ((2^26, 32) words over 16) and
    # the queries' batch over 'data' (256 x 230 bytes over 16)
    assert rec["memory_stats"]["argument_size_in_bytes"] == \
        (1 << 26) * 32 * 4 // 16 + 256 * 230 // 16


def test_run_cell_destroys_its_group_on_failure(tmp_path, monkeypatch):
    pytest.importorskip(
        "torch.testing._internal.distributed.fake_pg",
        reason=f"torch {torch.__version__} has no fake process group")
    from repro_torch.launch import mesh as mesh_mod

    def broken(**kw):
        assert dist.is_initialized() and dist.get_world_size() == 512
        raise RuntimeError("mesh failed")
    monkeypatch.setattr(mesh_mod, "make_production_mesh", broken)
    with pytest.raises(RuntimeError, match="mesh failed"):
        dryrun.run_cell("mind", "serve_p99", "multi", str(tmp_path))
    assert not dist.is_initialized()


def test_roofline_terms():
    r = analysis.Roofline(
        arch="x", shape="y", mesh="single", chips=256,
        flops_per_chip=989e12, bytes_per_chip=3.35e12,
        coll_bytes_per_chip=450e9, coll_breakdown={})
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(1.0)
    assert r.t_bound == pytest.approx(1.0)
    one = analysis.Roofline(
        arch="x", shape="y", mesh="one", chips=1, flops_per_chip=989e9,
        bytes_per_chip=2 * 3.35e9, coll_bytes_per_chip=None,
        coll_breakdown={}, model_flops=494.5e9)
    assert one.t_collective is None
    assert one.bottleneck == "memory"
    assert one.t_bound == pytest.approx(2e-3)
    assert one.useful_flops_fraction == pytest.approx(0.5)
    assert one.roofline_fraction == pytest.approx(0.5)
    assert json.loads(json.dumps(one.to_json()))["t_collective"] is None


def test_load_records_and_table(tmp_path):
    recs = [analysis.Roofline("a", "s", "single", 256, 1e12, 1e12, None, {},
                              model_flops=1e14).to_json(),
            analysis.Roofline("b", "s", "multi", 512, 1e9, 1e6, 4.5e8, {}
                              ).to_json()]
    path = tmp_path / "records.json"
    path.write_text(json.dumps(recs))
    rows = analysis.load_records(str(path))
    assert [r.to_json() for r in rows] == recs
    table = analysis.format_table(rows)
    assert "n/a" in table and "memory" in table and "collective" in table


def _band(spec, cfg, cell):
    if spec.family == "recsys":
        return FACTORS["recsys", None]
    mode = "train" if cell.kind == "train" else cell.meta["mode"]
    if mode == "decode" and cfg.moe is not None:
        return FACTORS["lm-moe", "decode"]
    return FACTORS["lm", mode]


LM_RECSYS_CELLS = [(arch, name) for arch in configs.all_archs()
                   if configs.get(arch).family in ("lm", "recsys")
                   for name, cell in configs.get(arch).cells()
                   if not cell.skip_reason]


@pytest.mark.parametrize("arch,cell_name", LM_RECSYS_CELLS)
def test_counted_flops_near_model_flops(arch, cell_name):
    spec = configs.get(arch)
    cfg = spec.make_config()
    cell = spec.shapes[cell_name]
    counts = dryrun.count_cell(spec, cfg, cell)
    lo, hi = _band(spec, cfg, cell)
    ratio = counts["flops"] / spec.model_flops_fn(cfg, cell)
    assert lo <= ratio <= hi, ratio
    assert counts["bytes"] > 0


def test_run_cell_counts_a_sharded_lm_train_step(tmp_path):
    """``granite-moe-1b-a400m train_4k`` cut to 2 layers, in this process:
    counted on the local shards, with the FSDP weight gathers, the
    gradient reductions and the MoE's expert layout among its
    collectives; one device's FLOPs times the chips within the train band
    of the unsharded count's ratio to ``model_flops``."""
    pytest.importorskip(
        "torch.testing._internal.distributed.fake_pg",
        reason=f"torch {torch.__version__} has no fake process group")
    rec = dryrun.run_cell("granite-moe-1b-a400m", "train_4k", "single",
                          str(tmp_path), overrides={"n_layers": 2})
    _check_ok(rec, 256)
    coll = rec["coll_breakdown"]
    assert coll["all-gather"] > 0 and coll["count"] > 0
    assert coll["all-reduce"] + coll["reduce-scatter"] > 0
    assert rec["flops_per_chip"] * 256 >= rec["even_split"][
        "flops_per_chip"] * 256 * (1 - 1e-9)
    lo, hi = FACTORS["lm", "train"]
    assert lo <= rec["flops_per_chip"] * 256 / rec["model_flops"] <= hi
    assert (tmp_path / "granite-moe-1b-a400m__train_4k__single.json").exists()


# how much work a device repeats in the sharded step beyond its even share
# of the unsharded count (measured on this tree in brackets): arctic's 56
# query heads split over 16 devices as 4 a device, 64/56 of its attention
# [1.018-1.071]; SASRec's one attention head cannot split over 'model', so
# each of its 16 devices computes the whole attention, its projections and
# both score products [6.41-6.75]; a retrieval cell's 1M candidate scores
# repeat on the 16 'model' devices, the reference's rules splitting the
# candidates over the data axes only [SASRec 21.65, MIND 15.99];
# otherwise at most 1%: the MoE router's (d, E) weight is replicated over
# 'model' by the reference's spec, and granite-moe's vocabulary 49,155
# splits 3,073 a device over 16 [granite-moe train 1.0016]
REPLICATION = {("arctic-480b", None): 64 / 56, ("sasrec", None): 7.0,
               ("sasrec", "retrieval_cand"): 22.0,
               ("mind", "retrieval_cand"): 16.0}
REPLICATION_ELSE = 1.01


@pytest.mark.parametrize("arch,cell_name", LM_RECSYS_CELLS)
def test_sharded_flops_near_model_flops(arch, cell_name):
    """Each LM and recsys cell counted on the sharded step's local shards
    at 256 devices (LM cells cut to 1 layer, in this process): one
    device's FLOPs times the chips equal the unsharded count of the same
    step, up to ``REPLICATION``."""
    pytest.importorskip(
        "torch.testing._internal.distributed.fake_pg",
        reason=f"torch {torch.__version__} has no fake process group")
    import dataclasses

    from repro_torch.launch import mesh as mesh_mod

    spec = configs.get(arch)
    cfg = spec.make_config()
    if spec.family == "lm":
        cfg = dataclasses.replace(cfg, n_layers=1)
    cell = spec.shapes[cell_name]
    with dryrun.fake_process_group(256):
        mesh = mesh_mod.make_production_mesh(device_type="cpu")
        local = dryrun.count_sharded(spec, cfg, cell, mesh)
    even = dryrun.count_cell(spec, cfg, cell)
    ratio = local["flops"] * 256 / even["flops"]
    cap = REPLICATION.get((arch, cell_name),
                          REPLICATION.get((arch, None), REPLICATION_ELSE))
    assert 1 - 1e-6 <= ratio <= cap, ratio
    assert local["bytes"] > 0 and local["coll"]["count"] >= 0
