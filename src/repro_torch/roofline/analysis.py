"""Three-term roofline of a dry-run cell, at the H100's rates.

    compute    = FLOPs_per_device / peak FLOP/s
    memory     = bytes_per_device / HBM bandwidth
    collective = collective_bytes_per_device / NVLink bandwidth

Port of :mod:`repro.roofline.analysis` for the card. The counts come from
:mod:`repro_torch.launch.dryrun`, which runs each cell's step sharded on
DTensors and counts one device's operators on its local shards: FLOPs,
bytes, and each collective's result bytes by the reference's kinds. The
reference's ``from_compiled`` and ``collective_bytes`` parse XLA's HLO
text, which the port never produces, and have no counterpart. Whenever
``coll_bytes_per_chip`` is a number, :attr:`Roofline.t_collective`,
:attr:`Roofline.bottleneck` and :attr:`Roofline.t_bound` take all three
terms; a record that counted no collective (``None``: the gene-search
cell, counted from its shapes) takes the two that exist.

Hardware constants: one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates): 989 TFLOP/s bf16, 3.35 TB/s HBM3, and NVLink 4 at 900 GB/s a
GPU in both directions together, 450 GB/s a direction. Every FLOP is
charged at the bf16 peak, so ``t_compute`` is a lower bound for f32 work.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional

PEAK_FLOPS = 989e12       # bf16 dense, FLOP/s a device
HBM_BW = 3.35e12          # bytes/s a device
NVLINK_BW = 450e9         # bytes/s a direction a device


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: Optional[float]
    coll_breakdown: dict
    model_flops: Optional[float] = None
    memory_stats: Optional[dict] = None

    @property
    def t_compute(self) -> float:
        """All FLOPs at the bf16 dense peak."""
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        if self.coll_bytes_per_chip is None:
            return None
        return self.coll_bytes_per_chip / NVLINK_BW

    def _terms(self) -> dict:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return {k: v for k, v in t.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        t = self._terms()
        return max(t, key=t.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time = max of the overlappable terms counted."""
        return max(self._terms().values())

    @property
    def useful_flops_fraction(self) -> Optional[float]:
        """MODEL_FLOPS / counted FLOPs (total over devices): the share of
        the counted work the model needs (remat and dispatch add the
        rest)."""
        if not self.model_flops:
            return None
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else None

    @property
    def roofline_fraction(self) -> float:
        """T_compute / T_bound (1.0 = compute-bound)."""
        tb = self.t_bound
        return self.t_compute / tb if tb else 0.0

    def to_json(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "memory_stats": self.memory_stats,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "t_bound": self.t_bound,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def memory_stats(pairs: Iterable) -> dict:
    """``argument_size_in_bytes``: one device's bytes of the step's
    arguments, from ``(leaf, NamedSharding)`` pairs (each leaf's local
    shard). The dry run adds ``output_size_in_bytes`` and
    ``temp_size_in_bytes`` from the sharded step's own allocations; the
    reference's code-size and alias keys come from XLA's buffer
    assignment and have no counterpart."""
    total = 0
    for leaf, sharding in pairs:
        n = 1
        for d in sharding.shard_shape(tuple(leaf.shape)):
            n *= d
        total += n * leaf.element_size()
    return {"argument_size_in_bytes": total}


def load_records(path: str) -> list[Roofline]:
    with open(path) as f:
        raw = json.load(f)
    return [Roofline(
        arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
        chips=r["chips"], flops_per_chip=r["flops_per_chip"],
        bytes_per_chip=r["bytes_per_chip"],
        coll_bytes_per_chip=r.get("coll_bytes_per_chip"),
        coll_breakdown=r.get("coll_breakdown", {}),
        model_flops=r.get("model_flops"),
        memory_stats=r.get("memory_stats"),
    ) for r in raw]


def format_table(rows: list[Roofline]) -> str:
    hdr = (f"{'arch':22} {'shape':14} {'mesh':6} "
           f"{'T_comp(s)':>10} {'T_mem(s)':>10} {'T_coll(s)':>10} "
           f"{'bound':>10} {'useful':>7} {'roofl%':>7}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        uf = r.useful_flops_fraction
        tc = r.t_collective
        lines.append(
            f"{r.arch:22} {r.shape:14} {r.mesh:6} "
            f"{r.t_compute:10.3e} {r.t_memory:10.3e} "
            f"{'n/a' if tc is None else f'{tc:10.3e}':>10} "
            f"{r.bottleneck:>10} "
            f"{'n/a' if uf is None else f'{uf:.2f}':>7} "
            f"{100 * r.roofline_fraction:6.1f}%"
        )
    return "\n".join(lines)
