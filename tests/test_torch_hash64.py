"""PyTorch port vs the JAX reference on the 64-bit hash path: kmers,
hashes, MinHash, the sliding minimum and its kernel's plain version, the
four schemes' locations, the registry and packed storage. Inputs come from
a seeded numpy generator and go through both packages; every comparison is
exact (uint64 values are compared through their int64 twins)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import hashing as j_hashing  # noqa: E402
from repro.core import idl as j_idl  # noqa: E402
from repro.core import kmers as j_kmers  # noqa: E402
from repro.core import minhash as j_minhash  # noqa: E402
from repro.index import packed as j_packed  # noqa: E402
from repro.index import registry as j_registry  # noqa: E402
from repro.kernels.window_min import kernel as j_wm_kernel  # noqa: E402
from repro_torch.core import hashing, idl, kmers, minhash  # noqa: E402
from repro_torch.index import packed, registry  # noqa: E402
from repro_torch.kernels.window_min import kernel as wm_kernel  # noqa: E402
from repro_torch.kernels.window_min import ops as wm_ops  # noqa: E402
from repro_torch.kernels.window_min import ref as wm_ref  # noqa: E402

SCHEMES = ("idl", "rh", "lsh", "idl-bbf")


def _u64_keys(rng, n=4096):
    """uint64 keys with bit 63 set in a quarter of them, plus edge values."""
    x = rng.integers(0, 2 ** 64, size=n, dtype=np.uint64)
    x[: n // 4] |= np.uint64(1 << 63)
    x[-6:] = [0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 2, 2 ** 64 - 1]
    return x


def _t(x: np.ndarray) -> "torch.Tensor":
    """uint64 numpy -> the int64 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


def _i64(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint64).view(np.int64)


def _cfgs(**kw):
    return j_idl.IDLConfig(**kw), idl.IDLConfig(**kw)


# -- kmers -------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 16, 31])
def test_pack_kmers(rng, k):
    codes = rng.integers(0, 4, size=(3, 120), dtype=np.uint8)
    got = kmers.pack_kmers(torch.from_numpy(codes), k)
    for i in range(3):
        want = np.asarray(j_kmers.pack_kmers(jnp.asarray(codes[i]), k))
        np.testing.assert_array_equal(got[i].numpy(), _i64(want))
        np.testing.assert_array_equal(kmers.pack_kmers_np(codes[i], k),
                                      j_kmers.pack_kmers_np(codes[i], k))
    with pytest.raises(ValueError):
        kmers.pack_kmers(torch.from_numpy(codes), 32)
    with pytest.raises(ValueError):
        kmers.pack_kmers(torch.from_numpy(codes[:, :10]), 11)


def test_subkmers_unpack_and_window(rng):
    codes = rng.integers(0, 4, size=200, dtype=np.uint8)
    want = np.asarray(j_kmers.subkmers_of_kmers(jnp.asarray(codes), 31, 16))
    got = kmers.subkmers_of_kmers(torch.from_numpy(codes), 31, 16)
    np.testing.assert_array_equal(got.numpy(), _i64(want))
    packed31 = kmers.pack_kmers(torch.from_numpy(codes), 31)
    for v in packed31[:5].tolist():
        assert kmers.unpack_kmer(v, 31) == j_kmers.unpack_kmer(v, 31)
    assert kmers.unpack_kmer(int(packed31[0]), 31) == \
        kmers.decode_bases(codes[:31])
    assert kmers.kmer_subkmer_window(31, 16) == \
        j_kmers.kmer_subkmer_window(31, 16) == 16
    with pytest.raises(ValueError):
        kmers.subkmers_of_kmers(torch.from_numpy(codes), 15, 16)


# -- hashing -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 0x0D0F, 0x5EED + 31 * 3, 2 ** 40 + 7])
def test_seed_const_mix64_hash64(rng, seed):
    x = _u64_keys(rng)
    assert hashing.seed_const64(seed) == int(j_hashing.seed_const64(seed))
    np.testing.assert_array_equal(
        hashing.mix64(_t(x)).numpy(), _i64(j_hashing.mix64(jnp.asarray(x))))
    want = _i64(j_hashing.hash64(jnp.asarray(x), seed))
    np.testing.assert_array_equal(hashing.hash64(_t(x), seed).numpy(), want)
    np.testing.assert_array_equal(hashing.np_hash64(x, seed),
                                  j_hashing.np_hash64(x, seed))


@pytest.mark.parametrize("m", [1, 7, 1 << 15, 1 << 30, 1 << 32])
def test_hash_to_range(rng, m):
    x = _u64_keys(rng)
    want = np.asarray(j_hashing.hash_to_range(jnp.asarray(x), 0x10CA, m))
    got = hashing.hash_to_range(_t(x), 0x10CA, m).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.min() >= 0 and got.max() < m
    np.testing.assert_array_equal(hashing.np_hash_to_range(x, 9, m),
                                  j_hashing.np_hash_to_range(x, 9, m))
    fam = hashing.hash_family_to_range(_t(x[:64]), [3, 4, 5], m)
    jfam = j_hashing.hash_family_to_range(jnp.asarray(x[:64]), [3, 4, 5], m)
    np.testing.assert_array_equal(fam.numpy(), np.asarray(jfam).astype(np.int64))


def test_hash_to_range_rejects_bad_ranges():
    for m in (0, (1 << 32) + 1):
        with pytest.raises(ValueError):
            hashing.hash_to_range(torch.zeros(3, dtype=torch.int64), 1, m)


def test_lshr_is_logical(rng):
    x = _u64_keys(rng)
    for s in (1, 17, 32, 33, 63):
        np.testing.assert_array_equal(
            hashing.lshr(_t(x), s).numpy(), (x >> np.uint64(s)).view(np.int64))


# -- the sliding minimum and the window_min kernel's plain version -----------

def _u64_with_fills(rng, n):
    x = _u64_keys(rng, n)
    x[rng.random(n) < 0.3] = np.uint64(2 ** 64 - 1)     # UINT64_MAX fills
    return x


@pytest.mark.parametrize("w", [1, 2, 9, 16, 31])
def test_sliding_window_min_unsigned_order(rng, w):
    """Sign-flipped uint64 hashes: signed min of the flipped values is the
    reference's unsigned min."""
    x = _u64_with_fills(rng, 500)
    want = _i64(j_minhash.sliding_window_min(jnp.asarray(x), w))
    flipped = _t(x) ^ minhash.SIGN
    got = minhash.sliding_window_min(flipped, w) ^ minhash.SIGN
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,w", [(1000, 16), (17, 16), (301, 7), (50, 31)])
def test_sliding_window_min_pads_with_dtype_max(rng, n, w):
    """Values above 2**32 in a last partial block: the pad must be the
    dtype's maximum (a 32-bit fill would win the suffix minimum)."""
    a = torch.from_numpy(rng.integers(1 << 33, 1 << 62, size=(2, n)))
    got = minhash.sliding_window_min(a, w)
    assert torch.equal(got, wm_ref.window_min_naive(a, w=w))
    assert int(got.min()) > (1 << 32)
    f = torch.from_numpy(rng.normal(size=n).astype(np.float32) + 1e6)
    assert torch.equal(minhash.sliding_window_min(f, w),
                       wm_ref.window_min_naive(f, w=w))


@pytest.mark.parametrize("n,w,tile", [
    (1000, 16, 256), (4096, 16, 512), (5000, 7, 1024),
    (300, 2, 128), (2048, 16, 2048), (1025, 12, 256),
])
def test_window_min_plain_vs_reference_kernel(rng, n, w, tile):
    a = rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    want = np.asarray(j_wm_kernel.window_min(jnp.asarray(a), w=w, tile=tile,
                                             interpret=True))
    before = wm_kernel.launches
    got = wm_ops.window_min(torch.from_numpy(a.astype(np.int64)), w)
    assert wm_kernel.launches == before          # plain version on the CPU
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_window_min_dtypes_vs_reference_kernel(rng, dtype):
    if np.issubdtype(dtype, np.floating):
        a = rng.normal(size=777).astype(dtype)
    else:
        a = rng.integers(0, 1 << 30, size=777).astype(dtype)
    want = np.asarray(j_wm_kernel.window_min(jnp.asarray(a), w=9, tile=128,
                                             interpret=True))
    carrier = a.astype(np.int64) if dtype == np.uint32 else a
    got = wm_ops.window_min(torch.from_numpy(carrier), 9).numpy()
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    assert torch.equal(wm_ref.window_min_ref(torch.from_numpy(carrier), w=9),
                       wm_ref.window_min_naive(torch.from_numpy(carrier), w=9))


def test_window_min_rejects_bad_windows():
    a = torch.zeros((2, 10), dtype=torch.int64)
    for w in (0, 11):
        with pytest.raises(ValueError):
            wm_kernel.window_min(a, w)


# -- the fused window_min: one call per MinHash -------------------------------

def _pallas_rows(x: np.ndarray, w: int) -> np.ndarray:
    """The reference's Pallas ``window_min`` (interpret mode), row by row
    over the last axis."""
    rows = x.reshape(-1, x.shape[-1])
    out = [np.asarray(j_wm_kernel.window_min(jnp.asarray(r), w=w, tile=256,
                                               interpret=True)) for r in rows]
    return np.stack(out).reshape(x.shape[:-1] + (-1,))


def _binned_case(rng, carrier, shape):
    """(values as the reference holds them, fill as the reference sees it,
    the port's fill, unsigned flag, DOPH bin shift) of one carrier: uint64
    hashes in int64, or uint32 lanes in int64."""
    if carrier == "u64":
        x = _u64_keys(rng, int(np.prod(shape))).reshape(shape)
        return x, np.uint64(2 ** 64 - 1), minhash.UINT64_MAX, True, 32
    x = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
    x.reshape(-1)[::5] |= np.uint32(1 << 31)                  # bit 31 set
    return x, np.uint32(minhash.FILL32), minhash.FILL32, False, 16


def _carry(x: np.ndarray) -> torch.Tensor:
    """The port's int64 carrier of uint64 hashes or uint32 lanes."""
    if x.dtype == np.uint64:
        return _t(x.reshape(-1)).reshape(x.shape)
    return torch.from_numpy(x.astype(np.int64))


@pytest.mark.parametrize("carrier", ["lanes64", "u64"])
def test_window_min_doph_form_vs_reference_kernel(rng, carrier):
    """The DOPH form: bin j's output equals the Pallas kernel over the hashes
    whose bin, ((h >> s) * η) >> s, is j; no hash falls in bin 3 of 4, so it
    stays all fill."""
    eta, w = 4, 16
    x, jfill, fill, unsigned, shift = _binned_case(rng, carrier, (2, 120))
    top2 = x.dtype.type(2 * shift - 2)        # bins of 4: the top two bits
    x[(x >> top2) == 3] ^= x.dtype.type(1) << top2          # bin 3 -> 2
    bins = (x.astype(np.uint64) >> np.uint64(shift)) * np.uint64(eta) \
        >> np.uint64(shift)
    assert set(np.unique(bins)) == {0, 1, 2}
    a = _carry(x)
    np.testing.assert_array_equal(wm_ref.doph_bins(a, eta, shift).numpy(),
                                  bins.astype(np.int64))
    before = wm_kernel.launches
    got = wm_ops.window_min(a, w, n_bins=eta, bin_shift=shift, fill=fill,
                            unsigned=unsigned)
    assert wm_kernel.launches == before          # plain version on the CPU
    assert got.shape == (2, eta, 120 - w + 1) and got.dtype == a.dtype
    for j in range(eta):
        want = _pallas_rows(np.where(bins == j, x, jfill), w)
        np.testing.assert_array_equal(
            got[:, j].numpy(), want.view(np.int64) if carrier == "u64"
            else want.astype(np.int64))
    assert (got[:, 3] == fill).all()


@pytest.mark.parametrize("carrier", ["lanes64", "u64"])
def test_window_min_exact_form_vs_reference_kernel(rng, carrier):
    """The exact form: an (B, η, n) input, every repetition in one call."""
    x, _, _, unsigned, _ = _binned_case(rng, carrier, (2, 3, 90))
    got = wm_ops.window_min(_carry(x), 7, unsigned=unsigned)
    want = _pallas_rows(x, 7)
    np.testing.assert_array_equal(
        got.numpy(), want.view(np.int64) if carrier == "u64"
        else want.astype(np.int64))


def test_window_min_binned_rejects_bad_arguments():
    a = torch.zeros((2, 10), dtype=torch.int64)
    for kw in (dict(n_bins=0, bin_shift=32), dict(n_bins=2),
               dict(n_bins=2, bin_shift=0), dict(n_bins=2, bin_shift=64)):
        with pytest.raises(ValueError):
            wm_ops.window_min(a, 3, **kw)
    with pytest.raises(ValueError):                 # the DOPH form is int64
        wm_ops.window_min(a.int(), 3, n_bins=2, bin_shift=16)
    for other in (a.float(), a.int()):              # unsigned is int64 only
        with pytest.raises(ValueError):
            wm_ops.window_min(other, 3, unsigned=True)


# -- MinHash -----------------------------------------------------------------

def test_doph_minhash_with_empty_bins():
    """η = 8 bins over windows of two sub-kmers leave most bins empty, so the
    UINT64_MAX sentinel and rotation densification both run."""
    codes = np.random.default_rng(7).integers(0, 4, size=300, dtype=np.uint8)
    subk = kmers.pack_kmers(torch.from_numpy(codes), 16)
    jsubk = j_kmers.pack_kmers(jnp.asarray(codes), 16)
    h = hashing.hash64(subk, 0x0D0F)
    bins = minhash._bins(h, 8)
    empty = torch.stack([minhash.sliding_window_min(
        torch.where(bins == j, 0, 1), 2) == 1 for j in range(8)])
    assert empty.any()
    want = _i64(j_minhash.doph_minhash(jsubk, 2, 8))
    np.testing.assert_array_equal(minhash.doph_minhash(subk, 2, 8).numpy(),
                                  want)


def test_densify_rotation_and_minhash_exact(rng):
    mh = _u64_keys(rng, 4 * 50).reshape(4, 50)
    mh[rng.random(mh.shape) < 0.5] = np.uint64(2 ** 64 - 1)
    mh[:, 0] = np.uint64(2 ** 64 - 1)                  # an all-empty column
    want = _i64(j_minhash.densify_rotation(jnp.asarray(mh)))
    np.testing.assert_array_equal(
        minhash.densify_rotation(_t(mh.reshape(-1)).reshape(4, 50)).numpy(),
        want)
    subk = rng.integers(0, 2 ** 32, size=120, dtype=np.uint64)
    seeds = [3, 0x0D0F, 2 ** 33 + 1]
    want = _i64(j_minhash.minhash_exact(jnp.asarray(subk), 16, seeds))
    np.testing.assert_array_equal(
        minhash.minhash_exact(_t(subk), 16, seeds).numpy(), want)


@pytest.mark.parametrize("mode", ["doph", "exact"])
def test_minhash_kmer_batch_vs_reference_and_rolling(rng, mode):
    codes = rng.integers(0, 4, size=150, dtype=np.uint8)
    k, t, eta = 31, 16, 4
    seeds = idl.IDLConfig().exact_seeds()
    km = kmers.pack_kmers(torch.from_numpy(codes), k)
    got = minhash.minhash_kmer_batch(km, k, t, eta, mode=mode, seeds=seeds)
    want = _i64(j_minhash.minhash_kmer_batch(
        j_kmers.pack_kmers(jnp.asarray(codes), k), k, t, eta, mode=mode,
        seeds=seeds))
    np.testing.assert_array_equal(got.numpy(), want)
    subk = kmers.pack_kmers(torch.from_numpy(codes), t)
    rolling = (minhash.minhash_exact(subk, k - t + 1, seeds) if mode == "exact"
               else minhash.doph_minhash(subk, k - t + 1, eta))
    assert torch.equal(got, rolling)
    with pytest.raises(ValueError):
        minhash.minhash_kmer_batch(km, k, t, eta, mode="exact")


def test_jaccard_subkmers(rng):
    a, b = (int(v) for v in rng.integers(0, 2 ** 62, size=2))
    assert minhash.jaccard_subkmers(a, b, 31, 16) == \
        j_minhash.jaccard_subkmers(a, b, 31, 16)
    assert minhash.jaccard_subkmers(a, a, 31, 16) == 1.0


# -- locations ---------------------------------------------------------------

_LOC_CFGS = [
    dict(k=31, t=16, L=1 << 12, eta=4, m=1 << 22),
    dict(k=21, t=9, L=1000, eta=3, m=300_007),        # non-power-of-two ranges
    dict(k=31, t=16, L=1 << 15, eta=4, m=1 << 32),    # the flat filter's m
]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mode", ["doph", "exact"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("kw", _LOC_CFGS)
def test_rolling_locations(rng, scheme, mode, align, kw):
    jc, tc = _cfgs(minhash_mode=mode, align=align, **kw)
    codes = rng.integers(0, 4, size=(2, 160), dtype=np.uint8)
    got = registry.locations(tc, torch.from_numpy(codes), scheme)
    for i in range(2):
        want = np.asarray(j_registry.locations(jc, jnp.asarray(codes[i]),
                                               scheme))
        np.testing.assert_array_equal(got[i].numpy(), want.astype(np.int64))
    assert int(got.min()) >= 0 and int(got.max()) < kw["m"]


@pytest.mark.parametrize("scheme", ["idl", "rh"])
@pytest.mark.parametrize("mode", ["doph", "exact"])
@pytest.mark.parametrize("align", [True, False])
def test_kmer_batch_locations(rng, scheme, mode, align):
    jc, tc = _cfgs(minhash_mode=mode, align=align, **_LOC_CFGS[2])
    codes = rng.integers(0, 4, size=130, dtype=np.uint8)
    km = kmers.pack_kmers(torch.from_numpy(codes), 31)
    jkm = j_kmers.pack_kmers(jnp.asarray(codes), 31)
    got = registry.kmer_locations(tc, km, scheme)
    want = np.asarray(j_registry.kmer_locations(jc, jkm, scheme))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert torch.equal(got, registry.locations(tc, torch.from_numpy(codes),
                                               scheme))


def test_registry_surface():
    assert registry.names() == j_registry.names()
    _, tc = _cfgs(**_LOC_CFGS[0])
    for scheme in ("lsh", "idl-bbf"):
        with pytest.raises(ValueError):
            registry.kmer_locations(tc, torch.zeros(3, dtype=torch.int64),
                                    scheme)
        with pytest.raises(ValueError):
            registry.locations32(tc, torch.zeros(40, dtype=torch.uint8),
                                 scheme)
    with pytest.raises(ValueError):
        registry.get("nope")
    codes = torch.from_numpy(
        np.random.default_rng(1).integers(0, 4, size=90, dtype=np.uint8))
    assert torch.equal(idl.locations(tc, codes, "rh"),
                       idl.rh_locations_rolling(tc, codes))


# -- packed storage ----------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
def test_batch_locations_64bit(rng, scheme):
    jc, tc = _cfgs(**_LOC_CFGS[0])
    reads = rng.integers(0, 4, size=(4, 100), dtype=np.uint8)
    want = np.asarray(j_packed.batch_locations(jc, jnp.asarray(reads), scheme))
    got = packed.batch_locations(tc, torch.from_numpy(reads), scheme)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_scatter_or_and_row_layouts(rng):
    words = rng.integers(0, 2 ** 32, size=64, dtype=np.uint64).astype(np.uint32)
    words[rng.random(64) < 0.7] = 0
    locs = rng.integers(0, 64 * 32 + 40, size=(3, 50))      # some past the end
    want = np.asarray(j_packed.scatter_or(jnp.asarray(words),
                                          jnp.asarray(locs)))
    tw = torch.from_numpy(words.view(np.int32).copy())
    got = packed.scatter_or(tw, torch.from_numpy(locs))
    assert got is tw
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    bits = rng.integers(0, 2, size=(3, 5, 64), dtype=np.uint8)
    jrows = np.asarray(j_packed.pack_rows(jnp.asarray(bits)))
    trows = packed.pack_rows(torch.from_numpy(bits))
    np.testing.assert_array_equal(trows.numpy().view(np.uint32), jrows)
    np.testing.assert_array_equal(packed.unpack_rows(trows, 64).numpy(), bits)
    with pytest.raises(ValueError):
        packed.pack_rows(torch.zeros((2, 33), dtype=torch.uint8))
