"""The registry's shape side in the PyTorch port against the reference.

For every arch and every non-skipped cell at the FULL config, the port's
``abstract_state`` and ``input_specs`` (tensors on the ``"meta"`` device)
against the reference's ``jax.eval_shape`` trees, leaf by leaf: the same
paths (the reference's ``_pp`` strings), the same shapes, and the same
dtypes under the port's recorded mappings, named in ``DTYPE_MAP``:

* uint32 (packed index words) -> int32 (the same bits);
* uint64 (a 64-bit hash) -> int64 (the same bits).

Also the counterpart of ``tests/test_models_smoke.py::TestAbstractCells``
(every cell builds state, inputs and a step), a meta init that allocates
nothing, and a meta init whose tree equals a real init's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as j_configs  # noqa: E402
from repro.configs import base as j_base  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import equiformer as eq  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_state as ts  # noqa: E402

# the port's dtype for a reference dtype, where they differ
DTYPE_MAP = {"uint32": "int32", "uint64": "int64"}

CELLS = [(arch, name) for arch in j_configs.all_archs()
         for name, cell in j_configs.get(arch).cells()
         if not cell.skip_reason]


def ref_leaves(tree) -> dict:
    """{path: (shape, dtype name)} of a reference tree of
    ``ShapeDtypeStruct`` (paths joined as its ``tree_shardings`` joins
    them)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(j_base._pp(p) for p in path):
            (tuple(leaf.shape), str(np.dtype(leaf.dtype)))
            for path, leaf in flat}


def port_leaves(tree) -> dict:
    return {path: (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
            for path, leaf in base.tree_paths(tree).items()}


def mapped(leaves: dict) -> dict:
    return {p: (s, DTYPE_MAP.get(d, d)) for p, (s, d) in leaves.items()}


def test_registry_lists_every_cell_of_the_reference():
    assert configs.all_archs() == j_configs.all_archs()
    for arch in configs.all_archs():
        spec, jspec = configs.get(arch), j_configs.get(arch)
        assert list(spec.shapes) == list(jspec.shapes)
        assert [n for n, _ in spec.cells()] == [n for n, _ in jspec.cells()]


@pytest.mark.parametrize("arch,cell_name", CELLS)
def test_abstract_state_and_inputs_match_reference(arch, cell_name):
    """Every leaf's path, shape and dtype (under ``DTYPE_MAP``), in the
    reference's order; every leaf lies on ``"meta"``."""
    spec, jspec = configs.get(arch), j_configs.get(arch)
    cfg, jcfg = spec.make_config(), jspec.make_config()
    cell, jcell = spec.shapes[cell_name], jspec.shapes[cell_name]
    state = spec.abstract_state(cfg, cell)
    inputs = spec.input_specs(cfg, cell)
    for got, want in ((state, jspec.abstract_state(jcfg, jcell)),
                      (inputs, jspec.input_specs(jcfg, jcell))):
        g, w = port_leaves(got), mapped(ref_leaves(want))
        assert list(g) == list(w)
        assert g == w
        assert all(leaf.device.type == "meta"
                   for leaf in base.tree_paths(got).values())


@pytest.mark.parametrize("arch", sorted(j_configs.all_archs()))
def test_cells_construct(arch):
    """The counterpart of ``TestAbstractCells``: every non-skipped cell
    builds state, inputs and a step function."""
    spec = configs.get(arch)
    cfg = spec.make_config()
    for name, cell in spec.cells():
        if cell.skip_reason:
            continue
        ins = spec.input_specs(cfg, cell)
        st = spec.abstract_state(cfg, cell)
        assert ins and st is not None
        assert callable(spec.step_fn(cfg, cell))


def test_meta_init_allocates_nothing():
    """nemotron-4-340b's train state (3.4e11 parameters, bf16, Adafactor's
    factored moments) built on meta: no CPU memory grows, and Adafactor's
    ``vr`` / ``vc`` / ``m`` are meta tensors of the factored shapes."""
    import resource

    spec = configs.get("nemotron-4-340b")
    cfg = spec.make_config()
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    state = spec.abstract_state(cfg, spec.shapes["train_4k"])
    grown_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    leaves = base.tree_paths(state)
    nbytes = sum(x.numel() * x.element_size() for x in leaves.values())
    assert nbytes > 1e12                  # over a terabyte described
    assert grown_kib < 64 * 1024          # under 64 MiB of host memory
    wq = state.params["layers"]["attn"]["wq"]
    per = state.opt_state["per_param"]["layers"]["attn"]["wq"]
    assert per["vr"].shape == wq.shape[:-1]
    assert per["vc"].shape == wq.shape[:-2] + wq.shape[-1:]
    assert per["m"].dtype == torch.bfloat16
    assert all(x.device.type == "meta" for x in leaves.values())


@pytest.mark.parametrize("which", ["lm", "lm_adafactor", "fm", "sasrec",
                                   "two-tower", "mind", "equiformer"])
def test_meta_init_has_the_real_init_tree(which):
    """A meta init and a real one (smoke configs, on the CPU) have the
    same paths, shapes and dtypes, and so do their train states."""
    smoke = {"lm": "granite-moe-1b-a400m", "lm_adafactor": "granite-20b",
             "fm": "fm", "sasrec": "sasrec", "two-tower":
             "two-tower-retrieval", "mind": "mind",
             "equiformer": "equiformer-v2"}[which]
    cfg = configs.get(smoke).make_smoke_config()
    init = {"lm": lambda d: tf.lm_init(0, cfg, device=d).params(),
            "lm_adafactor": lambda d: tf.lm_init(
                0, cfg, dtype=torch.bfloat16, device=d).params(),
            "fm": lambda d: recsys.fm_init(0, cfg, device=d),
            "sasrec": lambda d: recsys.sasrec_init(0, cfg, device=d),
            "two-tower": lambda d: recsys.twotower_init(0, cfg, device=d),
            "mind": lambda d: recsys.mind_init(0, cfg, device=d),
            "equiformer": lambda d: eq.equiformer_init(0, cfg, device=d)
            }[which]
    optimizer = opt.adafactor() if which == "lm_adafactor" else opt.adamw()
    real = ts.TrainState.create(init("cpu"), optimizer)
    meta = ts.TrainState.create(init("meta"), optimizer)
    assert port_leaves(meta) == port_leaves(real)
    assert all(x.device.type == "meta"
               for x in base.tree_paths(meta).values())
