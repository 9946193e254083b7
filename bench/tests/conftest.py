"""The benchmark's tests: they run on the CPU at smoke sizes (the kernels'
plain versions stand in for the CUDA kernels), except those marked
``cuda``, which skip without a card.

    python -m pytest -q bench/tests
"""

import dataclasses
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a cell's deployment cut to a CPU test: 64 files of 400-3,000 bases, a
# (2^18, 2) index with a 2^10-row window; widths as configured
SMOKE_CONFIG = {"n_files": 64, "m": 1 << 18, "L": 1 << 10,
                "file_bases": [400, 3000]}
SMOKE_MIX = {"batch_reads": 16, "check_per_batch": 4,
             "pool_reads_per_s": 640, "warm_batches": 2}


def smoke(cell):
    """``cell`` (a ``harness.spec.Cell``) at smoke size."""
    mix = dict(cell.mix, **{k: v for k, v in SMOKE_MIX.items()
                            if k in cell.mix})
    if "service" in mix:
        mix["service"] = dict(mix["service"], max_batch=16)
    return dataclasses.replace(cell, config=dict(cell.config, **SMOKE_CONFIG),
                               mix=mix)


@pytest.fixture
def smoke_cell():
    from harness import spec

    return lambda name: smoke(spec.load_cell(name))
