"""repro_torch — the IDL gene-search system in PyTorch, with CUDA kernels.

A port of the JAX package ``repro`` (which stays the reference) to PyTorch
on an NVIDIA Hopper card. The port mirrors the reference's module paths and
public names; inside it uses plain functions on tensors, frozen dataclasses
for plans and configs, and an explicit ``device`` argument on every entry
point (default ``"cuda"``; pass ``"cpu"`` to run the plain versions).

Integer conventions (torch on the CPU has no ``>>`` for unsigned types):

* 64-bit hashes travel in ``int64`` tensors with the reference's
  ``uint64`` bits: products and sums wrap alike, every ``>>`` is made
  logical (``core.hashing.lshr``), and an unsigned minimum flips the sign
  bit before and after (``core.minhash.SIGN``); ``UINT64_MAX`` is ``-1``;
* 32-bit lane hashes travel in ``int64`` tensors holding values in
  ``[0, 2**32)``, masked with ``& 0xFFFFFFFF`` after every product and sum,
  so shifts are logical and the ``0xFFFFFFFF`` empty-bin sentinel sorts
  last;
* locations are ``int64`` in ``[0, m)``: the reference's uint32 ones up
  to m = 2**32, and past it on the 64-bit path, where the reference's
  wrap (a flat filter of 2**35 bits);
* packed bit-matrix words are ``int32`` tensors holding the same 32 bits
  as the reference's ``uint32`` words (compare with ``.view(np.uint32)``).

The kernels (``gather_planned_rows``, ``insert_planned``, ``window_min``,
``probe_planned_bits``, and ``idl_locations32`` / ``idl_locations64``,
which turn codes into locations in one launch) are hand-written CUDA C++
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``
(:mod:`repro_torch.kernels.build`).
"""

__version__ = "0.1.0"
