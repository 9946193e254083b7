"""idl-genesearch — the paper's own system: a bit-sliced COBS-style index
over 1024 files queried with batched MSMT (port of
:mod:`repro.configs.idl_genesearch`, configs only)."""

from __future__ import annotations

from repro_torch.serving import genesearch as gs

NAME = "idl-genesearch"


def full_config() -> gs.GeneSearchConfig:
    return gs.GeneSearchConfig(
        name="idl-genesearch", n_files=1024, m=1 << 26,
        k=31, t=16, L=1 << 17, eta=4, read_len=230, scheme="idl",
    )


def smoke_config() -> gs.GeneSearchConfig:
    return gs.GeneSearchConfig(
        name="idl-genesearch-smoke", n_files=64, m=1 << 18,
        k=31, t=12, L=1 << 10, eta=2, read_len=100, scheme="idl",
    )
