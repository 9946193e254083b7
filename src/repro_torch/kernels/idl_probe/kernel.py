"""Wrappers of the CUDA kernels ``csrc/gather_planned_rows.cu``,
``csrc/probe_planned_bits.cu`` and ``csrc/probe_plan_counts.cu``, and their
operand.

Both kernels take the probe stream itself, a ``(..., η, n_k)`` int64 tensor
in probe order, and write one answer per key: the AND over the η
repetitions, which the reference computes after its kernel.
``gather_planned_rows`` replaces the Pallas kernel
``repro/kernels/idl_probe/kernel.py::probe_rows`` (rows of a packed
matrix); its bit mode ``gather_planned_bits`` (the same source, for wide
rows: RAMBO's transposed ``(m/32, R·B)`` filters) replaces ``probe_rows``
followed by the reference's bit extraction; ``probe_planned_bits``
replaces the flat-filter Pallas kernel ``probe_runs`` (bits of the packed
words, one thread per key). No run plan, pad lane or probe
index reaches the card. The main path's operand is a
:class:`CompactProbePlan`, which holds the stream with its smallest and
largest element on the host; a bare tensor's are read from the device.
``probe_plan_counts`` computes those two and the planner's run count in
one pass over the stream (:func:`plan_counts`). A CPU tensor takes the
plain version (:mod:`.ref`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.idl_probe import ref
from repro_torch.obs import metrics as obs_metrics

NAME = "gather_planned_rows"
SOURCE = "src/repro_torch/csrc/gather_planned_rows.cu"
REPLACES = "src/repro/kernels/idl_probe/kernel.py:99"

BIT_MODE_NAME = "gather_planned_bits"    # the bit mode's C entry point

BITS_NAME = "probe_planned_bits"
BITS_SOURCE = "src/repro_torch/csrc/probe_planned_bits.cu"
BITS_REPLACES = "src/repro/kernels/idl_probe/kernel.py:149"

PLAN_COUNTS_NAME = "probe_plan_counts"
PLAN_COUNTS_SOURCE = "src/repro_torch/csrc/probe_plan_counts.cu"
PLAN_COUNTS_REPLACES = None   # the JAX package plans with numpy
PLAN_COUNTS_BLOCKS = 512     # block records a workspace holds

# Kernel launches so far, one counter per kernel (reset and read by callers
# that must show the kernel ran); they count launches only, never the plain
# versions.
launches = 0            # gather_planned_rows
bit_mode_launches = 0   # gather_planned_bits, its bit mode
bits_launches = 0       # probe_planned_bits
plan_counts_launches = 0  # probe_plan_counts


def count(counter: str, path: str) -> None:
    """Count one event in ``counter{path=...}`` of the process registry
    (its handle bound again if the registry was replaced): which
    implementation, the hand-written kernel or its plain version, served a
    plan (``index.probe_plans``) or a flat filter's probe
    (``index.bit_probes``)."""
    reg = obs_metrics.DEFAULT
    bound = _COUNTERS.get((counter, path))
    if bound is None or bound[0] is not reg:
        bound = _COUNTERS[(counter, path)] = (
            reg, reg.counter(counter, path=path))
    bound[1].inc()


_COUNTERS: dict = {}

# the C entry points' arguments, the stream last
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
    [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BITS_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PLAN_COUNTS_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_longlong] * 4 + \
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


@dataclasses.dataclass
class CompactProbePlan:
    """A batch's probe stream on the device, with the reference planner's
    counters (built by ``ops.compact_probe_plan``)."""

    rows: torch.Tensor        # (..., n) int64 probe stream, the kernels'
                              # operand: row indices, or bit locations for
                              # a bit probe; leading dims are the streams
    n_probes: int
    n_runs: int               # runs of <= C probes (the planner's)
    eta: int                  # streams, P (the planner's name)
    n_keys: int               # probes per stream, n
    min_row: Optional[int]    # smallest and largest element, on the host
    max_row: Optional[int]    # (None when the stream is empty)
    block_bits: int
    probes_per_run: int

    def run_lengths(self) -> np.ndarray:
        """(n_runs,) int32 probes per run in the planner's run order. Built
        on demand (a device pass and a copy to the host), for the parity
        tests; the serve path does not call it."""
        starts = torch.nonzero(ref.run_starts(
            self.rows, self.block_bits, self.probes_per_run))[:, 0]
        ends = torch.cat([starts[1:], starts.new_tensor([self.n_probes])])
        return (ends - starts).to(torch.int32).cpu().numpy()


def plan_counts(rows: torch.Tensor, block_bits: int,
                probes_per_run: int) -> torch.Tensor:
    """(3,) int64 on the stream's device: the reference planner's run count
    of the non-empty (..., n) int64 probe stream ``rows`` (its leading dims
    are streams, planned in blocks of ``block_bits`` and runs of at most
    ``probes_per_run``), its smallest element and its largest. One launch
    of ``probe_plan_counts`` on a CUDA stream; the plain version on a CPU
    one."""
    if rows.dtype != torch.int64 or rows.dim() < 1 or rows.numel() == 0 \
            or block_bits < 1 or probes_per_run < 1:
        raise ValueError(
            f"{PLAN_COUNTS_NAME}: want a non-empty int64 stream and sizes of "
            f"at least 1, got {tuple(rows.shape)} {rows.dtype}, block_bits "
            f"{block_bits}, probes_per_run {probes_per_run}")
    if rows.device.type == "cpu":
        return ref.plan_counts_ref(rows, block_bits, probes_per_run)
    if not rows.is_contiguous():
        raise ValueError(f"{PLAN_COUNTS_NAME}: the stream must be contiguous")
    out = torch.empty((3,), dtype=torch.int64, device=rows.device)
    build.launch(PLAN_COUNTS_NAME, _PLAN_COUNTS_ARGTYPES, rows.device,
                 rows.data_ptr(), rows.numel(), rows.shape[-1], block_bits,
                 probes_per_run, _workspace(rows.device).data_ptr(),
                 PLAN_COUNTS_BLOCKS, out.data_ptr())
    global plan_counts_launches
    plan_counts_launches += 1
    return out


def _workspace(device: torch.device) -> torch.Tensor:
    """The ``probe_plan_counts`` workspace of the current stream of
    ``device``: zeroed once, and left zeroed by every launch. One a stream,
    so launches that may overlap never share one."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = torch.zeros(
            (1 + 5 * PLAN_COUNTS_BLOCKS,), dtype=torch.int64, device=device)
    return ws


_WORKSPACES: dict = {}


def gather_planned_rows(matrix: torch.Tensor,
                        operand: torch.Tensor | CompactProbePlan
                        ) -> torch.Tensor:
    """``out[..., k, :] = AND_e matrix[rows[..., e, k], :]``: the
    ``(..., n_k, W)`` int32 AND over η of the rows of the ``(n_rows, W)``
    int32 ``matrix`` that a ``(..., η, n_k)`` int64 row tensor names.

    The operand is a :class:`CompactProbePlan` (the main path's: its
    smallest and largest row on the host) or a bare row tensor, whose
    bounds are read from the device. A row outside the matrix raises before
    anything is launched.
    """
    rows, bounds = _operand(operand)
    _check(NAME, matrix, (2,), rows, bounds, matrix.shape[0])
    if matrix.device.type == "cpu":
        return ref.gather_and_ref(matrix, rows)
    out = _launch_gather(matrix, rows, NAME)
    if out.numel():
        global launches
        launches += 1
    return out


def gather_planned_bits(matrix: torch.Tensor,
                        operand: torch.Tensor | CompactProbePlan
                        ) -> torch.Tensor:
    """The bit mode of :func:`gather_planned_rows`: ``out[..., k, w] = AND_e
    bit (loc & 31) of matrix[loc >> 5, w]`` with ``loc = locs[..., e, k]``,
    the ``(..., n_k, W)`` int32 {0, 1} answers of an ``(n_rows, W)`` int32
    matrix for a ``(..., η, n_k)`` int64 tensor of bit locations. What
    :func:`probe_planned_bits` computes, laid out for wide rows: a warp per
    key, its lanes across the row.

    The operand is a :class:`CompactProbePlan` or a bare tensor; a location
    past ``32 · n_rows`` raises before anything is launched.
    """
    locs, bounds = _operand(operand)
    _check(BIT_MODE_NAME, matrix, (2,), locs, bounds, 32 * matrix.shape[0])
    if matrix.device.type == "cpu":
        return ref.gather_bits_and_ref(matrix, locs)
    out = _launch_gather(matrix, locs, BIT_MODE_NAME)
    if out.numel():
        global bit_mode_launches
        bit_mode_launches += 1
    return out


def _launch_gather(matrix: torch.Tensor, rows: torch.Tensor,
                   entry: str) -> torch.Tensor:
    """Launch ``entry`` of ``gather_planned_rows.cu`` (the row gather or its
    bit mode) into a new answers' tensor, unless it is empty."""
    w = matrix.shape[1]
    out = _out(matrix, rows)
    if out.numel():
        vector = w % 4 == 0 and matrix.data_ptr() % 16 == 0
        build.launch(NAME, _ARGTYPES, matrix.device, matrix.data_ptr(),
                     rows.data_ptr(), out.data_ptr(), out.numel() // w,
                     rows.shape[-1], rows.shape[-2], w, int(vector),
                     entry=entry)
    return out


def probe_planned_bits(words: torch.Tensor,
                       operand: torch.Tensor | CompactProbePlan
                       ) -> torch.Tensor:
    """``out[..., k, w] = AND_e bit (loc & 31) of words[loc >> 5, w]`` with
    ``loc = locs[..., e, k]``: the ``(..., n_k)`` int32 {0, 1} answers of
    the packed ``(n_words,)`` int32 flat filter (``(..., n_k, W)`` of an
    ``(n_rows, W)`` matrix) for a ``(..., η, n_k)`` int64 tensor of bit
    locations.

    The operand is a :class:`CompactProbePlan` or a bare tensor, as for
    :func:`gather_planned_rows`; a location past the words raises before
    anything is launched. Each call counts in ``index.bit_probes{path=
    kernel}`` (a CUDA filter) or ``{path=plain}`` (a CPU one).
    """
    locs, bounds = _operand(operand)
    _check(BITS_NAME, words, (1, 2), locs, bounds, 32 * words.shape[0])
    if words.device.type == "cpu":
        count("index.bit_probes", "plain")
        return ref.probe_bits_and_ref(words, locs)
    count("index.bit_probes", "kernel")
    out = _out(words, locs)
    if out.numel():
        w = words.shape[1] if words.dim() == 2 else 1
        build.launch(BITS_NAME, _BITS_ARGTYPES, words.device,
                     words.data_ptr(), locs.data_ptr(), out.data_ptr(),
                     out.numel() // w, locs.shape[-1], locs.shape[-2], w)
        global bits_launches
        bits_launches += 1
    return out


def _operand(operand):
    """(stream, (min, max) or None) of a plan or a bare tensor."""
    if isinstance(operand, CompactProbePlan):
        return operand.rows, (operand.min_row, operand.max_row)
    return operand, None


def _check(name: str, matrix: torch.Tensor, ndims: tuple, rows: torch.Tensor,
           bounds, limit: int) -> None:
    """Raise unless ``matrix`` has one of ``ndims`` dims and ``rows`` is an
    int64 tensor of at least two dims on its device whose elements
    (``bounds`` when the caller holds them, else read from the device) lie
    in ``[0, limit)``; on a CUDA matrix both must also be contiguous, the
    matrix int32."""
    if matrix.dim() not in ndims or rows.dim() < 2 or \
            rows.dtype != torch.int64 or rows.device != matrix.device:
        raise ValueError(
            f"{name}: want a {ndims}-D matrix and (..., eta, n_k) int64 "
            f"probes on its device, got matrix {tuple(matrix.shape)} on "
            f"{matrix.device}, probes {tuple(rows.shape)} {rows.dtype} on "
            f"{rows.device}")
    if matrix.device.type != "cpu":
        build.check_operands(name, matrix=matrix)
        if not rows.is_contiguous():
            raise ValueError(f"{name}: probes must be contiguous")
    if rows.numel() == 0:
        return
    lo, hi = bounds if bounds is not None else \
        torch.stack([rows.min(), rows.max()]).tolist()
    if lo < 0 or hi >= limit:
        raise ValueError(f"{name}: probes span [{lo}, {hi}], outside "
                         f"[0, {limit})")


def _out(matrix: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The answers' tensor: ``rows.shape[:-2] + (n_k,) + matrix.shape[1:]``
    int32 on the matrix's device."""
    return torch.empty(rows.shape[:-2] + rows.shape[-1:] + matrix.shape[1:],
                       dtype=torch.int32, device=matrix.device)
