"""Checkpoints in the reference's on-disk format, with async save.

Port of :mod:`repro.train.checkpoint`. One ``ckpt_%08d.npz`` per step holds
every leaf under its flattened tree path (JAX's key path strings:
``.params/embed``, ``.opt_state/mu/...``, ``.step``; a ``None`` leaf is
absent), plus a ``ckpt_%08d.json`` manifest (each leaf's shape and dtype
name, the step, and json-serializable ``extra`` such as the pipeline
cursor). Both files are written under a temporary name and renamed into
place. Either package restores the other's checkpoints.

A bf16 leaf is written as the reference writes one: its 16-bit patterns
under the npy descr ``'<V2'`` (the reference's ``bfloat16`` array has no
numpy type of its own), so ``np.load`` gives a ``|V2`` array; the port
reads its bits back as ``uint16`` and views them as ``torch.bfloat16``.

Async save: the device -> host copy happens on the caller's thread (the
train step updates the state in place right after), the file write runs
in a background thread; :meth:`CheckpointManager.wait` joins it before the
next save, a restore, or exit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import zipfile

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor


def _flatten_with_paths(tree) -> dict:
    """{path: leaf} in JAX's order: dict keys sorted, a dataclass's fields
    in order as ``.name``, ``None`` leaves absent."""
    flat: dict = {}
    _walk(tree, [], flat)
    return flat


def _walk(node, parts: list, flat: dict) -> None:
    # a module-level recursion: a recursive closure would keep ``flat``
    # (the tree's tensors) in a reference cycle until the collector runs
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], parts + [str(k)], flat)
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            _walk(getattr(node, f.name), parts + ["." + f.name], flat)
    else:
        flat["/".join(parts)] = node


def _rebuild(tree, values: dict, parts=()):
    """``tree``'s structure with each leaf replaced by ``values[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, parts + (str(k),))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), values,
                             parts + ("." + f.name,))
            for f in dataclasses.fields(tree)})
    return values["/".join(parts)]


def dtype_name(x: torch.Tensor) -> str:
    """The manifest's dtype string (numpy's name: ``float32``,
    ``bfloat16``, ``int32``)."""
    return str(x.dtype).replace("torch.", "")


def to_host(x: torch.Tensor) -> np.ndarray:
    """A leaf as a numpy array of its own with the leaf's bits (a copy even
    of a CPU tensor, which the next step updates in place); a bf16 tensor
    as ``uint16`` patterns (written under the ``'<V2'`` descr)."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
    return x.to("cpu", copy=True).numpy()


def from_host(arr: np.ndarray, like: torch.Tensor,
              device=None) -> torch.Tensor:
    """A loaded leaf as a tensor of ``like``'s dtype on ``device`` (default
    ``like``'s). A ``|V2`` array is bf16 bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.asarray(arr, order="C").view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(arr, order="C"))
    return t.to(dtype=like.dtype,
                device=like.device if device is None else device)


def _savez(path: str, host: dict, bf16: set) -> None:
    """``np.savez`` (stored, zip64 entries) with the bf16 leaves' descr
    written as the reference's ``'<V2'``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in host.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if key in bf16:
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": "<V2", "fortran_order": False,
                        "shape": arr.shape})
                    fid.write(np.asarray(arr, order="C").reshape(-1).view(
                        np.uint8).data)
                else:
                    np.lib.format.write_array(fid, np.asarray(arr, order="C"),
                                              allow_pickle=False)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, extra: dict | None = None,
             blocking: bool = False) -> str:
        """Snapshot ``tree`` (+ json-serializable ``extra``) at ``step``."""
        self.wait()
        flat = _flatten_with_paths(tree)
        host = {k: to_host(v) for k, v in flat.items()}
        bf16 = {k for k, v in flat.items() if dtype_name(v) == "bfloat16"}
        manifest = {
            "step": int(step),
            "extra": extra or {},
            "leaves": {
                k: {"shape": list(host[k].shape), "dtype": dtype_name(v)}
                for k, v in flat.items()
            },
        }
        path = os.path.join(self.directory, f"ckpt_{step:08d}")

        def write():
            _savez(path + ".tmp.npz", host, bf16)
            os.replace(path + ".tmp.npz", path + ".npz")
            with open(path + ".json.tmp", "w") as f:
                json.dump(manifest, f)
            os.replace(path + ".json.tmp", path + ".json")
            self._gc()

        if blocking:
            write()
        else:
            def run():
                try:
                    write()
                except BaseException as e:      # re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        return path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.directory, f"ckpt_{s:08d}{ext}"))
                except FileNotFoundError:
                    pass

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.directory):
            if f.startswith("ckpt_") and f.endswith(".json"):
                out.append(int(f[5:13]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None, device=None,
                sharding_fn=None):
        """Restore into the structure of ``tree_like``: each leaf takes its
        ``tree_like`` leaf's dtype, on ``device`` (default: that leaf's
        device). ``sharding_fn(path) -> (mesh, placements) | None`` places
        a leaf on a target mesh instead (the reference's ``sharding_fn``;
        ``path`` is the leaf's checkpoint key): it comes back as a DTensor
        of those placements whose local shard this process slices from the
        saved leaf, with nothing communicated. Returns (tree,
        manifest)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"ckpt_{step:08d}")
        with open(path + ".json") as f:
            manifest = json.load(f)
        restored = {}
        with np.load(path + ".npz") as data:
            for key, like in _flatten_with_paths(tree_like).items():
                if key not in data:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                arr = data[key]
                if tuple(arr.shape) != tuple(like.shape):
                    raise ValueError(
                        f"{key}: checkpoint shape {arr.shape} != model "
                        f"{tuple(like.shape)}")
                target = sharding_fn(key) if sharding_fn else None
                if target is None:
                    restored[key] = from_host(arr, like, device)
                    continue
                mesh, placements = target
                restored[key] = distribute_tensor(
                    from_host(arr, like, mesh.device_type), mesh,
                    list(placements), src_data_rank=None)
        return _rebuild(tree_like, restored), manifest
