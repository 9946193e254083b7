"""PyTorch port vs the JAX reference: kmers, hashes, sliding minima and
32-bit lane locations. Inputs come from a seeded numpy generator and go
through both packages; every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import hashing as j_hashing  # noqa: E402
from repro.core import idl as j_idl  # noqa: E402
from repro.core import kmers as j_kmers  # noqa: E402
from repro.core import minhash as j_minhash  # noqa: E402
from repro_torch.core import hashing, idl, kmers, minhash  # noqa: E402


def _u32_keys(rng, n=4096):
    x = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    x[:64] |= np.uint32(0x80000000)          # bit 31 set
    x[-8:] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF,
                0xDEADBEEF, 0x9E3779B9]
    return x


def _t(x: np.ndarray) -> "torch.Tensor":
    return torch.from_numpy(x.astype(np.int64))


def test_encode_decode_match_reference():
    s = "ACGTacgtNNAC" * 7
    np.testing.assert_array_equal(kmers.encode_bases(s), j_kmers.encode_bases(s))
    codes = kmers.encode_bases(s)
    assert kmers.decode_bases(codes) == j_kmers.decode_bases(codes)


@pytest.mark.parametrize("t", [1, 7, 12, 16])
def test_pack_kmers_u32(rng, t):
    codes = rng.integers(0, 4, size=300, dtype=np.uint8)
    want = np.asarray(j_kmers.pack_kmers_u32(jnp.asarray(codes), t))
    got = kmers.pack_kmers_u32(torch.from_numpy(codes), t).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("k", [5, 16, 17, 31])
def test_pack_kmers_pair32(rng, k):
    codes = rng.integers(0, 4, size=300, dtype=np.uint8)
    whi, wlo = j_kmers.pack_kmers_pair32(jnp.asarray(codes), k)
    hi, lo = kmers.pack_kmers_pair32(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(whi).astype(np.int64))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(wlo).astype(np.int64))


def test_pack_kmers_batched_equals_per_read(rng):
    codes = rng.integers(0, 4, size=(5, 120), dtype=np.uint8)
    batched = kmers.pack_kmers_u32(torch.from_numpy(codes), 16)
    for i in range(5):
        assert torch.equal(batched[i],
                           kmers.pack_kmers_u32(torch.from_numpy(codes[i]), 16))


def test_mix32(rng):
    x = _u32_keys(rng)
    want = np.asarray(j_hashing.mix32(jnp.asarray(x)))
    np.testing.assert_array_equal(hashing.mix32(_t(x)).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 0x10CA, 0x5EED + 31 * 3, 2 ** 31 + 5])
def test_hash_pair32(rng, seed):
    hi, lo = _u32_keys(rng), _u32_keys(rng)[::-1].copy()
    want = np.asarray(j_hashing.hash_pair32(jnp.asarray(hi), jnp.asarray(lo),
                                            seed))
    got = hashing.hash_pair32(_t(hi), _t(lo), seed).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("m", [
    1, 3, 1000, (1 << 15) - 1,                # Lemire split branch (m < 2^15)
    1 << 15, 1 << 17, 1 << 24, 1 << 31,       # power-of-two shift branch
    (1 << 15) + 1, 12_345_678, (1 << 31) - 1,  # modulo branch
])
def test_hash32_to_range_all_branches(rng, m):
    h = _u32_keys(rng)
    want = np.asarray(j_hashing.hash32_to_range(jnp.asarray(h), m))
    got = hashing.hash32_to_range(_t(h), m).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.min() >= 0 and got.max() < m


def test_hash32_to_range_rejects_bad_ranges():
    for m in (0, (1 << 31) + 1):
        with pytest.raises(ValueError):
            hashing.hash32_to_range(torch.zeros(3, dtype=torch.int64), m)


def test_mul32_matches_uint32_wraparound(rng):
    x = _u32_keys(rng)
    for c in (3, 0x7FFFFFFF, 0x85EBCA6B, 0xFFFFFFFF):
        want = (x.astype(np.uint64) * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        np.testing.assert_array_equal(hashing.mul32(_t(x), c).numpy(),
                                      want.astype(np.int64))


def test_to_int32_bits_roundtrip(rng):
    x = _u32_keys(rng)
    got = hashing.to_int32_bits(_t(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("n,w", [(1000, 16), (17, 16), (16, 16), (300, 2),
                                 (1025, 12), (50, 1)])
def test_sliding_window_min(rng, n, w):
    a = _u32_keys(rng, n)
    want = np.asarray(j_minhash.sliding_window_min(jnp.asarray(a), w))
    got = minhash.sliding_window_min(_t(a), w).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_sliding_window_min_batched_and_errors(rng):
    a = _t(_u32_keys(rng, 3 * 200)).reshape(3, 200)
    out = minhash.sliding_window_min(a, 9)
    for i in range(3):
        assert torch.equal(out[i], minhash.sliding_window_min(a[i], 9))
    with pytest.raises(ValueError):
        minhash.sliding_window_min(a, 0)
    with pytest.raises(ValueError):
        minhash.sliding_window_min(a, 201)


def _cfgs(**kw):
    return j_idl.IDLConfig(**kw), idl.IDLConfig(**kw)


@pytest.mark.parametrize("mode", ["doph", "exact"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("kw", [
    dict(k=31, t=16, L=1 << 12, eta=4, m=1 << 22),
    dict(k=31, t=12, L=1 << 10, eta=2, m=1 << 18),
    dict(k=21, t=9, L=1000, eta=3, m=300_007),    # modulo ranges
    dict(k=31, t=16, L=1 << 17, eta=4, m=1 << 26),  # the full config
])
def test_idl_locations_rolling32(rng, mode, align, kw):
    jc, tc = _cfgs(minhash_mode=mode, align=align, **kw)
    codes = rng.integers(0, 4, size=400, dtype=np.uint8)
    want = np.asarray(j_idl.idl_locations_rolling32(jc, jnp.asarray(codes)))
    got = idl.idl_locations_rolling32(tc, torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("align", [True, False])
def test_idl_locations_with_empty_doph_bins(align):
    """Eight DOPH bins over windows of two sub-kmers leave most bins empty
    in every window, so the sentinel and rotation densification run."""
    jc, tc = _cfgs(k=17, t=16, L=64, eta=8, m=1 << 14, align=align)
    codes = np.random.default_rng(7).integers(0, 4, size=200, dtype=np.uint8)
    subk = kmers.pack_kmers_u32(torch.from_numpy(codes), tc.t)
    h = hashing.mix32((hashing.mul32(subk, 0x9E3779B9) + 0x0D0F) & hashing.M32)
    bins = ((h >> 16) * tc.eta) >> 16
    occupied = torch.stack([minhash.sliding_window_min(
        torch.where(bins == j, 0, 1), tc.w) == 0 for j in range(tc.eta)])
    assert (~occupied).any()                      # empty bins exist
    want = np.asarray(j_idl.idl_locations_rolling32(jc, jnp.asarray(codes)))
    got = idl.idl_locations_rolling32(tc, torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("kw", [
    dict(k=31, t=16, L=1 << 12, eta=4, m=1 << 22),
    dict(k=21, t=9, L=1000, eta=3, m=300_007),
])
def test_rh_locations_rolling32(rng, kw):
    jc, tc = _cfgs(**kw)
    codes = rng.integers(0, 4, size=400, dtype=np.uint8)
    want = np.asarray(j_idl.rh_locations_rolling32(jc, jnp.asarray(codes)))
    got = idl.rh_locations_rolling32(tc, torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_idl_config_matches_reference():
    for kw in (dict(), dict(L=1 << 10, m=1 << 18, eta=2, align=False)):
        jc, tc = _cfgs(**kw)
        assert (tc.w, tc.m_part, tc.anchor_range, tc.exact_seeds()) == \
            (jc.w, jc.m_part, jc.anchor_range, jc.exact_seeds())
    for bad in (dict(t=32), dict(t=5, k=4), dict(m=1 << 10, L=1 << 9)):
        with pytest.raises(ValueError):
            idl.IDLConfig(**bad)
