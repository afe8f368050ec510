"""FAST, ORB and descriptor matching of both packages on the same NumPy
inputs (``ops/fast.py``, ``ops/orb.py``, ``ops/matching.py``), on the CPU.

Tolerances: integer outputs equal (Hamming distances, ``knn2``,
``radius_match``, ``mutual_best`` and ``_hamming_all``, ties included: the
port's bit-matmul Hamming form is exact, and ``torch.argmin`` takes the
first index among ties as ``jnp.argmin`` does); ``pairwise_l2_sq`` 1e-5
relative (the same formula, sums in another order); ``fast_response`` 1e-4
relative and ``fast_detect``'s valid corners equal as a set; ``orientation``
1e-4 rad; ``brief_describe`` theta 1e-4 rad, ``ok`` equal, descriptors at
most 2 bits apart on >= 99 % of the valid keypoints (a pair of samples
within roundoff of each other may flip its bit).  Then the JAX package's own
properties (``tests/test_orb.py``, ``test_matching_fast.py``), held by the
port: self-match 0, rotation invariance, discriminability, border flags,
a flat image giving no corners.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from mqslam_tpu.frontend import loopclosure as jlc
from mqslam_tpu.ops import fast as jfast, matching as jmatch, orb as jorb

from mqslam_tpu_torch.frontend import loopclosure as tlc
from mqslam_tpu_torch.ops import fast as tfast, matching as tmatch
from mqslam_tpu_torch.ops import orb as torb


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small eager ops: one torch thread is as fast, and beside parallel
    test workers many threads a process spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _texture(seed=3, H=240, W=320, sigma=2.0):
    rng = np.random.RandomState(seed)
    img = ndi.gaussian_filter(rng.rand(H, W), sigma)
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return img.astype(np.float32)


def _rotate_about(img, deg, center):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    mat = np.array([[c, -s], [s, c]])
    off = np.asarray(center) - mat @ np.asarray(center)
    return ndi.affine_transform(img, mat, offset=off, order=3,
                                mode="nearest").astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _descs(seed, n, m, flips=0):
    """Random 32-byte descriptors, ``b``'s first rows near copies of ``a``'s
    (``flips`` bits flipped) so that distances tie often."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, (n, 32), np.uint8)
    b = rng.randint(0, 256, (m, 32), np.uint8)
    k = min(n, m) // 2
    b[:k] = a[:k]
    for r in range(k):
        for bit in rng.choice(256, flips, replace=False):
            b[r, bit // 8] ^= np.uint8(1 << (bit % 8))
    b[k:k + 3] = b[0]            # duplicate train rows: ties in argmin
    return a, b


# ---------------------------------------------------------------- matching

@pytest.mark.parametrize("n, m, flips", [(30, 25, 0), (64, 80, 3),
                                         (7, 200, 9)])
def test_pairwise_hamming_equal(n, m, flips):
    a, b = _descs(n + m, n, m, flips)
    want = np.asarray(jmatch.pairwise_hamming(jnp.asarray(a),
                                              jnp.asarray(b)))
    got = tmatch.pairwise_hamming(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the definition, bit by bit
    bits = np.unpackbits(a[:, None] ^ b[None], axis=-1).sum(-1)
    np.testing.assert_array_equal(got.numpy(), bits)


def test_unpack_bits_order():
    d = torch.tensor([[1, 128, 6]], dtype=torch.uint8)
    bits = tmatch.unpack_bits(d)
    assert bits.shape == (1, 24)
    assert np.flatnonzero(bits.numpy()[0]).tolist() == [0, 15, 17, 18]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_knn2_ties_equal(seed):
    a, b = _descs(seed, 40, 60, flips=seed * 4)
    d = np.asarray(jmatch.pairwise_hamming(jnp.asarray(a), jnp.asarray(b)))
    want = jmatch.knn2(jnp.asarray(d))
    got = tmatch.knn2(torch.tensor(d))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    # integer rows tie: the first index wins in both
    assert (np.sort(d, axis=1)[:, 0] == np.sort(d, axis=1)[:, 1]).any()


def test_knn2_float_masks_with_inf():
    d = np.array([[3.0, 1.0, 1.0, 5.0], [2.0, 2.0, 2.0, 2.0]], np.float32)
    want = jmatch.knn2(jnp.asarray(d))
    got = tmatch.knn2(torch.tensor(d))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("max_distance", [40, 100, 128])
def test_radius_match_equal(max_distance):
    a, b = _descs(5, 50, 70, flips=20)
    d = np.asarray(jmatch.pairwise_hamming(jnp.asarray(a), jnp.asarray(b)))
    want = jmatch.radius_match(jnp.asarray(d), max_distance)
    got = tmatch.radius_match(torch.tensor(d), max_distance)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_radius_match_semantics(rng):
    a = rng.randn(20, 8).astype(np.float32)
    b = rng.randn(30, 8).astype(np.float32)
    d = tmatch.pairwise_l2_sq(torch.tensor(a), torch.tensor(b))
    idx, dist, valid = tmatch.radius_match(d, max_distance=8.0)
    d_np = d.numpy()
    for q in range(20):
        order = np.argsort(d_np[q], kind="stable")
        within = [j for j in order[:2] if d_np[q, j] <= 8.0]
        got = [int(i) for i, v in zip(idx[q], valid[q]) if v]
        assert got == within, (q, got, within)


@pytest.mark.parametrize("seed", [0, 7])
def test_mutual_best_equal(seed):
    a, b = _descs(seed, 50, 40, flips=6)
    d = np.asarray(jmatch.pairwise_hamming(jnp.asarray(a), jnp.asarray(b)))
    for dd in (d, d.T.copy()):
        want = jmatch.mutual_best(jnp.asarray(dd))
        got = tmatch.mutual_best(torch.tensor(dd))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_pairwise_l2_sq(rng):
    a = rng.randn(40, 32).astype(np.float32) * 3
    b = rng.randn(50, 32).astype(np.float32) * 3
    want = np.asarray(jmatch.pairwise_l2_sq(jnp.asarray(a), jnp.asarray(b)))
    got = tmatch.pairwise_l2_sq(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    exact = ((a[:, None].astype(np.float64) - b[None]) ** 2).sum(-1)
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-3)


def test_ratio_and_mutual(rng):
    a = rng.randn(15, 4).astype(np.float32)
    b = np.concatenate([a + 0.01 * rng.randn(15, 4).astype(np.float32),
                        rng.randn(10, 4).astype(np.float32) * 5])
    d = tmatch.pairwise_l2_sq(torch.tensor(a), torch.tensor(b))
    i1, d1, i2, d2 = tmatch.knn2(d)
    accept = tmatch.ratio_test(d1, d2, 0.7)
    np.testing.assert_array_equal(i1.numpy(), np.arange(15))
    assert bool(accept.all())
    want = jmatch.ratio_test(jnp.asarray(d1.numpy()), jnp.asarray(
        d2.numpy()), 0.7)
    np.testing.assert_array_equal(accept.numpy(), np.asarray(want))
    fwd, mutual = tmatch.mutual_best(d)
    np.testing.assert_array_equal(fwd.numpy(), np.arange(15))
    assert bool(mutual.all())


def test_hamming_all_equal():
    rng = np.random.RandomState(4)
    q = rng.randint(0, 256, (24, 32), np.uint8)
    db = rng.randint(0, 256, (5, 24, 32), np.uint8)
    db[2, :12] = q[:12]
    want = np.asarray(jlc._hamming_all(jnp.asarray(q), jnp.asarray(db)))
    got = tlc._hamming_all(torch.tensor(q), torch.tensor(db))
    assert got.shape == (5, 24, 24) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------------- FAST

def _blob_image(seed=5):
    rng = np.random.RandomState(seed)
    img = (rng.rand(120, 160) > 0.99).astype(np.float32)
    return ndi.gaussian_filter(img * 255.0, 1.0).astype(np.float32) * 20


@pytest.mark.parametrize("which, threshold", [("texture", 4.0),
                                              ("texture", 10.0),
                                              ("blobs", 5.0),
                                              ("blobs", 20.0)])
def test_fast_response_and_detect(which, threshold):
    img = _texture(sigma=1.5)[:120, :160] if which == "texture" \
        else _blob_image()
    want = np.asarray(jfast.fast_response(jnp.asarray(img), threshold))
    got = tfast.fast_response(torch.tensor(img), threshold).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (want > 0).sum() > 10
    uj, sj, vj = jfast.fast_detect(jnp.asarray(img), threshold, 96)
    ut, st, vt = tfast.fast_detect(torch.tensor(img), threshold, 96)
    set_j = {tuple(u) for u, v in zip(np.asarray(uj), np.asarray(vj)) if v}
    set_t = {tuple(u) for u, v in zip(ut.numpy(), vt.numpy()) if v}
    assert set_t == set_j and len(set_t) > 5
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4)


def test_fast_detect_tie_order_is_raster():
    """Equal scores come out in raster order (``lax.top_k``'s order)."""
    img = np.full((40, 40), 50.0, np.float32)
    for (y, x) in ((10, 30), (10, 10), (30, 20), (20, 10)):
        img[y, x] = 250.0          # four identical isolated bright dots
    uj, sj, vj = jfast.fast_detect(jnp.asarray(img), 20.0, 8)
    ut, st, vt = tfast.fast_detect(torch.tensor(img), 20.0, 8)
    assert int(vt.sum()) == 4 and len(set(st.numpy()[:4])) == 1
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_flat_image_no_corners():
    img = torch.full((64, 64), 100.0)
    uv, score, valid = tfast.fast_detect(img, max_corners=32)
    assert not bool(valid.any())


# --------------------------------------------------------------------- ORB

def test_orb_pattern_equal_and_bounded():
    pat = torb.orb_pattern()
    np.testing.assert_array_equal(pat, jorb.orb_pattern())
    assert pat.shape == (torb.N_BITS, 4)
    r = max(np.hypot(pat[:, 0], pat[:, 1]).max(),
            np.hypot(pat[:, 2], pat[:, 3]).max())
    assert r <= torb.PATCH_RADIUS - 2 + 1e-6


@pytest.mark.parametrize("deg", [0.0, 45.0, 120.0, -90.0])
def test_orientation(deg):
    a = np.deg2rad(deg)
    y, x = np.mgrid[:torb._P, :torb._P].astype(np.float32)
    c = torb._P // 2
    ramp = ((x - c) * np.cos(a) + (y - c) * np.sin(a)).astype(np.float32)
    rng = np.random.RandomState(int(deg) % 7)
    patches = np.stack([ramp, ramp * 3 + 7, rng.rand(*ramp.shape) * 255])
    patches = patches.astype(np.float32)
    want = np.asarray(jorb.orientation(jnp.asarray(patches)))
    got = torb.orientation(torch.tensor(patches)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    err = (np.rad2deg(got[0]) - deg + 180.0) % 360.0 - 180.0
    assert abs(err) < 2.0


def _hold_descriptors(img, uv, valid):
    dj, thj, okj = jorb.brief_describe(jnp.asarray(img), jnp.asarray(uv),
                                       jnp.asarray(valid))
    dt, tht, okt = torb.brief_describe(torch.tensor(img), torch.tensor(uv),
                                       torch.tensor(valid))
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert okj.sum() >= 10
    np.testing.assert_allclose(tht.numpy()[okj], np.asarray(thj)[okj],
                               atol=1e-4)
    flips = np.unpackbits(dt.numpy()[okj] ^ np.asarray(dj)[okj],
                          axis=1).sum(1)
    assert (flips <= 2).mean() >= 0.99, np.bincount(flips)
    return flips


@pytest.mark.parametrize("seed", [0, 1])
def test_brief_describe_equal(seed):
    img = _texture(seed=seed + 3)
    rng = np.random.RandomState(seed)
    uv = np.stack([rng.uniform(-5, 330, 192), rng.uniform(-5, 250, 192)],
                  1).astype(np.float32)
    valid = rng.rand(192) > 0.2
    _hold_descriptors(img, uv, valid)


def test_brief_describe_dead_slots_carry_nan():
    """Dead tracks may hold NaN coordinates (``run_frontend`` describes
    ``cur_uv``): no index from ``floor(NaN)``, ``ok`` False there, and the
    live slots described as without them."""
    img = _texture(seed=9)
    rng = np.random.RandomState(3)
    uv = np.stack([rng.uniform(20, 300, 64), rng.uniform(20, 220, 64)],
                  1).astype(np.float32)
    valid = np.ones(64, bool)
    uv_nan = uv.copy()
    uv_nan[::5] = np.nan
    valid_nan = valid.copy()
    valid_nan[::5] = False
    d0, t0, ok0 = torb.brief_describe(torch.tensor(img), torch.tensor(uv))
    d1, t1, ok1 = torb.brief_describe(torch.tensor(img), torch.tensor(uv_nan),
                                      torch.tensor(valid_nan))
    assert not bool(ok1[::5].any())
    live = ok1.numpy()
    np.testing.assert_array_equal(d1.numpy()[live], d0.numpy()[live])
    np.testing.assert_array_equal(t1.numpy()[live], t0.numpy()[live])
    _hold_descriptors(img, np.nan_to_num(uv_nan), valid_nan)


def test_orb_features_equal():
    img = _blob_image(seed=5)
    img = np.pad(img, ((60, 60), (80, 80)))
    wj = jorb.orb_features(jnp.asarray(img), max_corners=128, threshold=5.0)
    wt = torb.orb_features(torch.tensor(img), max_corners=128, threshold=5.0)
    np.testing.assert_array_equal(wt[4].numpy(), np.asarray(wj[4]))
    v = np.asarray(wj[4])
    assert v.sum() >= 10 and wt[1].shape == (128, 32)
    np.testing.assert_array_equal(wt[0].numpy()[v], np.asarray(wj[0])[v])
    flips = np.unpackbits(wt[1].numpy()[v] ^ np.asarray(wj[1])[v],
                          axis=1).sum(1)
    assert (flips <= 2).mean() >= 0.99


def test_self_match_is_zero():
    img = torch.tensor(_texture())
    uv = torch.tensor([[60.0, 80.0], [200.0, 100.0], [150.0, 160.0]])
    d1, _, ok = torb.brief_describe(img, uv)
    d2, _, _ = torb.brief_describe(img, uv)
    assert bool(ok.all())
    assert torch.equal(d1, d2)
    assert (tmatch.pairwise_hamming(d1, d2).diagonal() == 0).all()


@pytest.mark.parametrize("deg", [15.0, 45.0, 90.0])
def test_rotation_invariance(deg):
    img = _texture()
    pt = np.array([160.0, 120.0], np.float32)
    d0, _, ok0 = torb.brief_describe(torch.tensor(img),
                                     torch.tensor(pt[None]))
    rot = _rotate_about(img, deg, center=(pt[1], pt[0]))
    d1, _, ok1 = torb.brief_describe(torch.tensor(rot),
                                     torch.tensor(pt[None]))
    assert bool(ok0[0]) and bool(ok1[0])
    assert int(tmatch.pairwise_hamming(d0, d1)[0, 0]) < 55


def test_discriminability():
    img = _texture(seed=11)
    shift = (7, -4)
    moved = ndi.shift(img, (shift[1], shift[0]), order=3,
                      mode="nearest").astype(np.float32)
    rng = np.random.RandomState(0)
    uv = np.stack([rng.uniform(40, 280, 64),
                   rng.uniform(40, 200, 64)], 1).astype(np.float32)
    d1, _, ok1 = torb.brief_describe(torch.tensor(img), torch.tensor(uv))
    d2, _, ok2 = torb.brief_describe(torch.tensor(moved),
                                     torch.tensor(uv + shift))
    nn = tmatch.pairwise_hamming(d1, d2).argmin(dim=1).numpy()
    ok = (ok1 & ok2).numpy()
    assert (nn == np.arange(64))[ok].mean() > 0.9


def test_border_points_flagged():
    img = torch.tensor(_texture())
    uv = torch.tensor([[3.0, 3.0], [160.0, 120.0], [319.0, 50.0]])
    _, _, ok = torb.brief_describe(img, uv)
    assert ok.tolist() == [False, True, False]
