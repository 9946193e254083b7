"""The fused location kernels' plain versions against the JAX reference.

``repro_torch.kernels.idl_locations`` computes the rolling locations of the
``idl`` and ``rh`` schemes on both paths in one launch on a card; on the
CPU its wrapper takes the plain versions (``ref.py``: the eager
composition, with ``window_min``'s plain version). Here the same seeded
numpy codes go through those and through ``repro.core.idl``'s
``idl_locations_rolling32``, ``rh_locations_rolling32``,
``idl_locations_rolling`` and ``rh_locations_rolling`` (the reference
takes one sequence: one call on the rows joined end to end, see
``_check``), and must agree exactly (tolerance 0: the
locations are integers). The range grid hits every branch of
``hash32_to_range`` (split Lemire product, top-bits shift, modulo) for the
window L, the anchor range and RH's partition.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import idl as j_idl  # noqa: E402
from repro.index import packed as j_packed  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import hashing, idl, kmers, minhash  # noqa: E402
from repro_torch.index import packed, registry  # noqa: E402
from repro_torch.kernels.idl_locations import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.window_min import ref as wm_ref  # noqa: E402

KT32 = [(31, 16), (20, 8), (16, 16)]
KT64 = KT32 + [(31, 24)]                 # t > 16: the 64-bit path only
# (L, m): which hash32_to_range branch each range takes is in the comment
# (L / aligned anchor m'/L / unaligned anchor m' - L / RH's m')
RANGES32 = {
    "A": (1 << 10, 1 << 22),     # Lemire / Lemire / modulo / shift
    "B": (1 << 15, 1 << 26),     # shift / Lemire / modulo / shift
    "C": (40_000, 1 << 24),      # modulo / Lemire / modulo / modulo
    "D": (1 << 10, 1 << 30),     # Lemire / shift / modulo / shift
    "E": (64, 1 << 14),          # Lemire / Lemire / modulo / Lemire
}
RANGES64 = {
    "A": (1 << 10, 1 << 22),
    "C": (40_000, 300_007),      # non-power-of-two m
    "F": (1 << 15, 1 << 32),     # the flat filter's m (m' = 2^32 at η 1)
}
ETAS = [1, 2, 4]

_J = {("idl", True): j_idl.idl_locations_rolling32,
      ("rh", True): j_idl.rh_locations_rolling32,
      ("idl", False): j_idl.idl_locations_rolling,
      ("rh", False): j_idl.rh_locations_rolling}
_PORT = {("idl", True): idl.idl_locations_rolling32,
         ("rh", True): idl.rh_locations_rolling32,
         ("idl", False): idl.idl_locations_rolling,
         ("rh", False): idl.rh_locations_rolling}


def _cfgs(**kw):
    return j_idl.IDLConfig(**kw), idl.IDLConfig(**kw)


def _rows(k: int, seed: int) -> list:
    """Code batches: two rows of length k (one kmer), two of 230 bases (a
    read), one of 3000 (several 256-kmer tiles)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, size=shape, dtype=np.uint8)
            for shape in ((2, k), (2, 230), (1, 3000))]


def _check(jc, tc, scheme: str, lane32: bool, seed: int) -> None:
    """The port on each batch against one reference call on all the rows
    joined end to end: a kmer's locations depend on its k codes alone, so
    each row's are the joined row's at that row's offset (the kmers that
    straddle a join are not compared)."""
    batches = _rows(tc.k, seed)
    joined = np.concatenate([row for codes in batches for row in codes])
    want = np.asarray(_J[(scheme, lane32)](jc, jnp.asarray(joined)))
    want = want.astype(np.int64)
    off = 0
    for codes in batches:
        got = _PORT[(scheme, lane32)](tc, torch.from_numpy(codes))
        n_k = codes.shape[1] - tc.k + 1
        assert got.dtype == torch.int64
        assert got.shape == (codes.shape[0], tc.eta, n_k)
        for i in range(codes.shape[0]):
            np.testing.assert_array_equal(got[i].numpy(),
                                          want[:, off:off + n_k])
            off += codes.shape[1]
    assert off == joined.size


@pytest.mark.parametrize("ranges", sorted(RANGES32))
@pytest.mark.parametrize("kt", KT32)
@pytest.mark.parametrize("eta", ETAS)
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("mode", ["doph", "exact"])
def test_idl_plain32_matches_reference(mode, align, eta, kt, ranges):
    L, m = RANGES32[ranges]
    jc, tc = _cfgs(k=kt[0], t=kt[1], L=L, eta=eta, m=m, minhash_mode=mode,
                   align=align)
    _check(jc, tc, "idl", True, seed=eta * 100 + kt[0])


@pytest.mark.parametrize("ranges", sorted(RANGES64))
@pytest.mark.parametrize("kt", KT64)
@pytest.mark.parametrize("eta", ETAS)
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("mode", ["doph", "exact"])
def test_idl_plain64_matches_reference(mode, align, eta, kt, ranges):
    L, m = RANGES64[ranges]
    jc, tc = _cfgs(k=kt[0], t=kt[1], L=L, eta=eta, m=m, minhash_mode=mode,
                   align=align)
    _check(jc, tc, "idl", False, seed=eta * 100 + kt[1])


@pytest.mark.parametrize("ranges", sorted(RANGES32))
@pytest.mark.parametrize("eta", ETAS)
@pytest.mark.parametrize("kt", KT32)
def test_rh_plain32_matches_reference(kt, eta, ranges):
    L, m = RANGES32[ranges]
    jc, tc = _cfgs(k=kt[0], t=kt[1], L=L, eta=eta, m=m)
    _check(jc, tc, "rh", True, seed=eta + kt[0])


@pytest.mark.parametrize("ranges", sorted(RANGES64))
@pytest.mark.parametrize("eta", ETAS)
@pytest.mark.parametrize("kt", KT64)
def test_rh_plain64_matches_reference(kt, eta, ranges):
    L, m = RANGES64[ranges]
    jc, tc = _cfgs(k=kt[0], t=kt[1], L=L, eta=eta, m=m)
    _check(jc, tc, "rh", False, seed=eta + kt[1])


@pytest.mark.parametrize("lane32", [True, False])
@pytest.mark.parametrize("align", [True, False])
def test_empty_doph_bins_match_reference(lane32, align):
    """Eight DOPH bins over windows of two sub-kmers leave bins empty in
    most windows, so the sentinel and rotation densification (chained on
    the 32-bit path, from the original minima on the 64-bit one) run."""
    jc, tc = _cfgs(k=17, t=16, L=64, eta=8, m=1 << 14, align=align)
    codes = np.random.default_rng(7).integers(0, 4, size=(2, 200),
                                              dtype=np.uint8)
    c = torch.from_numpy(codes)
    if lane32:
        subk = kmers.pack_kmers_u32(c, tc.t)
        h = hashing.mix32((hashing.mul32(subk, 0x9E3779B9) + 0x0D0F)
                          & hashing.M32)
        bins = wm_ref.doph_bins(h, tc.eta, 16)
    else:
        h = hashing.hash64(kmers.pack_kmers(c, tc.t), 0x0D0F)
        bins = wm_ref.doph_bins(h, tc.eta, minhash.BIN_SHIFT)
    occupied = torch.stack([wm_ref.window_min_naive(
        (bins != j).to(torch.int64), w=tc.w) == 0 for j in range(tc.eta)])
    assert (~occupied).any()                      # empty bins exist
    got = _PORT[("idl", lane32)](tc, c)
    for i in range(2):
        want = np.asarray(_J[("idl", lane32)](jc, jnp.asarray(codes[i])))
        np.testing.assert_array_equal(got[i].numpy(), want.astype(np.int64))


@pytest.mark.parametrize("lane32", [True, False])
@pytest.mark.parametrize("scheme", ["idl", "rh"])
def test_cpu_tensor_launches_no_kernel(scheme, lane32):
    """On a CPU tensor the wrapper takes the plain version: neither fused
    kernel nor ``window_min`` counts a launch, and the result is the plain
    version's."""
    _, tc = _cfgs(k=31, t=16, L=1 << 12, eta=4, m=1 << 22)
    codes = torch.from_numpy(np.random.default_rng(3).integers(
        0, 4, size=(3, 230), dtype=np.uint8))
    before = kernels.launch_counts()
    got = _PORT[(scheme, lane32)](tc, codes)
    assert kernels.launch_counts() == before
    assert torch.equal(got, kernel._PLAIN[(scheme, lane32)](tc, codes))
    assert torch.equal(got, ops.locations(tc, codes, scheme, lane32=lane32))


@pytest.mark.parametrize("lane32", [True, False])
@pytest.mark.parametrize("scheme", ["idl", "rh"])
@pytest.mark.parametrize("mode", ["doph", "exact"])
def test_batch_locations_and_registry_unchanged(scheme, lane32, mode):
    """``packed.batch_locations`` and the registry, which reach the fused
    entry points, give the reference's batched (vmapped) locations, and the
    registry gives the plain version's on one sequence."""
    jc, tc = _cfgs(k=31, t=16, L=1 << 12, eta=4, m=1 << 22,
                   minhash_mode=mode)
    reads = np.random.default_rng(5).integers(0, 4, size=(4, 120),
                                              dtype=np.uint8)
    want = np.asarray(j_packed.batch_locations(jc, jnp.asarray(reads), scheme,
                                               lane32=lane32))
    got = packed.batch_locations(tc, torch.from_numpy(reads), scheme,
                                 lane32=lane32)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    one = torch.from_numpy(reads[1])
    fn = registry.locations32 if lane32 else registry.locations
    assert torch.equal(fn(tc, one, scheme),
                       kernel._PLAIN[(scheme, lane32)](tc, one))


def test_range_branches_match_hashing():
    """The host's branch choice (``kernel.range32``) is the one
    ``hashing.hash32_to_range`` takes: same reductions on every branch, the
    same refusals."""
    h = torch.from_numpy(np.random.default_rng(2).integers(
        0, 1 << 32, size=4096, dtype=np.int64))
    for m, kind in ((1, 0), (1000, 0), (1 << 14, 0), (1 << 15, 1),
                    (1 << 31, 1), (40_000, 2), ((1 << 31) - 1, 2)):
        r = kernel.range32(m)
        assert (r.m, r.kind) == (m, kind)
        if kind == 0:
            got = (((h >> 16) * m) + (((h & 0xFFFF) * m) >> 16)) >> 16
        elif kind == 1:
            got = h >> r.shift
        else:
            got = h % m
        assert torch.equal(got, hashing.hash32_to_range(h, m))
    for m in (0, -1, (1 << 31) + 1):
        with pytest.raises(ValueError):
            kernel.range32(m)
        with pytest.raises(ValueError):
            hashing.hash32_to_range(h, m)
    assert kernel.range64(1 << 32).m == 1 << 32
    for m in (0, (1 << 32) + 1):
        with pytest.raises(ValueError):
            kernel.range64(m)


def test_params_seeds_and_ranges():
    """The kernel's configuration: seeds' constants and ranges as the plain
    versions use them."""
    tc = idl.IDLConfig(k=31, t=16, L=1 << 15, eta=4, m=1 << 26, align=False)
    p32 = kernel.params(tc, "idl", True)
    p64 = kernel.params(tc, "idl", False)
    assert (p32.k, p32.t, p32.eta, p32.rh, p32.exact) == (31, 16, 4, 0, 0)
    assert p32.anchor.m == tc.anchor_range and p32.scale == 1
    assert list(p32.anchor_seed)[:4] == [3, 5, 7, 9]
    assert p64.local_seed[2] == hashing.seed_const64(0x10CA + 62)
    assert p64.mh_seed == hashing.seed_const64(0x0D0F)
    rh = kernel.params(tc, "rh", False)
    assert rh.rh == 1 and rh.local.m == tc.m_part
    assert rh.local_seed[1] == hashing.seed_const64(0x5EED + 31)


@pytest.mark.parametrize("case", [
    "dtype", "device", "rank0", "rank3", "non_contiguous", "short",
    "t_over_16", "eta_over_max", "scheme", "range_over_2_31"])
def test_argument_errors(case):
    """The checks run before the CPU/CUDA split, so a CPU tensor exercises
    them: wrong dtype, device or rank, a non-contiguous operand, n < k,
    t > 16 on the 32-bit path, η above the kernel's 16, an unknown scheme,
    and a range the 32-bit reduction cannot take."""
    cfg = idl.IDLConfig(k=31, t=16, L=1 << 12, eta=4, m=1 << 22)
    codes = torch.zeros((2, 230), dtype=torch.uint8)
    lane32, scheme = True, "idl"
    if case == "dtype":
        codes = codes.to(torch.int64)
    elif case == "device":
        codes = torch.zeros((2, 230), dtype=torch.uint8, device="meta")
    elif case == "rank0":
        codes = torch.zeros((), dtype=torch.uint8)
    elif case == "rank3":
        codes = torch.zeros((2, 2, 230), dtype=torch.uint8)
    elif case == "non_contiguous":
        codes = torch.zeros((230, 2), dtype=torch.uint8).t()
    elif case == "short":
        codes = codes[:, :30].contiguous()
    elif case == "t_over_16":
        cfg = idl.IDLConfig(k=31, t=20, L=1 << 12, eta=4, m=1 << 22)
    elif case == "eta_over_max":
        cfg = idl.IDLConfig(k=31, t=16, L=1 << 8, eta=17, m=1 << 22)
        lane32 = False
    elif case == "scheme":
        scheme = "lsh"
    else:
        cfg = idl.IDLConfig(k=31, t=16, L=1 << 15, eta=1, m=1 << 32)
        scheme = "rh"
    with pytest.raises(ValueError):
        kernel.locations(cfg, codes, scheme, lane32=lane32)
    if case == "non_contiguous":                  # the entry point copies
        assert torch.equal(ops.locations(cfg, codes, scheme, lane32=True),
                           ref.idl_locations32_ref(cfg, codes.contiguous()))
