"""mqslam_tpu_torch.ops.features against mqslam_tpu.ops.features on the
CPU, on smooth random textures made with NumPy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.frontend import synthetic as jsyn
from mqslam_tpu.ops import features as jf
from mqslam_tpu_torch.ops import features as tf


@pytest.fixture(scope="module")
def imgs():
    tex = jsyn.make_texture(np.random.RandomState(11), size=512)
    return np.stack([tex[:240, :320], tex[100:340, 150:470]]
                    ).astype(np.float32)


def test_shi_tomasi_response(imgs):
    """Response values reach ~1e4 on a 0..255 image: rtol 1e-5 with a small
    absolute floor for the flat regions (same separable sums, term order
    kept)."""
    ref = jf.shi_tomasi_response(jnp.asarray(imgs[0]))
    got = tf.shi_tomasi_response(torch.tensor(imgs[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-3)
    both = tf.shi_tomasi_response(torch.tensor(imgs))
    np.testing.assert_array_equal(both[0].numpy(), got.numpy())
    with pytest.raises(NotImplementedError):
        tf.shi_tomasi_response(torch.tensor(imgs[0]), block_size=5)


def test_min_distance_mask():
    rng = np.random.RandomState(0)
    cand = (rng.rand(50, 2) * 100).astype(np.float32)
    ex = (rng.rand(20, 2) * 100).astype(np.float32)
    exv = rng.rand(20) > 0.3
    ref = jf.min_distance_mask(jnp.asarray(cand), jnp.asarray(ex),
                               jnp.asarray(exv), 12)
    got = tf.min_distance_mask(torch.tensor(cand), torch.tensor(ex),
                               torch.tensor(exv), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got.all() and got.any()


@pytest.mark.parametrize("max_corners,cell", [(96, 12), (160, 14), (400, 12)])
def test_detect_corners(imgs, max_corners, cell):
    """Valid corners equal, in the same (response) order.  Pad entries are
    -inf ties, ordered arbitrarily by either top-k: only their validity is
    compared."""
    ref_uv, ref_v = jf.detect_corners(jnp.asarray(imgs[0]),
                                      max_corners=max_corners, cell=cell)
    uv, v = tf.detect_corners(torch.tensor(imgs[0]), max_corners=max_corners,
                              cell=cell)
    ref_v = np.asarray(ref_v)
    np.testing.assert_array_equal(v.numpy(), ref_v)
    np.testing.assert_array_equal(uv.numpy()[ref_v], np.asarray(ref_uv)[ref_v])
    assert ref_v.sum() > 40


def test_detect_corners_existing_and_batch(imgs):
    rng = np.random.RandomState(5)
    existing = (rng.rand(2, 60, 2) * [320, 240]).astype(np.float32)
    ex_valid = rng.rand(2, 60) > 0.25
    existing[~ex_valid] = np.nan      # dead slots may hold anything
    uv_b, v_b = tf.detect_corners(torch.tensor(imgs), max_corners=128,
                                  cell=12, existing=torch.tensor(existing),
                                  existing_valid=torch.tensor(ex_valid))
    assert uv_b.shape == (2, 128, 2) and v_b.shape == (2, 128)
    for a in range(2):
        ref_uv, ref_v = jf.detect_corners(
            jnp.asarray(imgs[a]), max_corners=128, cell=12,
            existing=jnp.asarray(existing[a]),
            existing_valid=jnp.asarray(ex_valid[a]))
        ref_v = np.asarray(ref_v)
        np.testing.assert_array_equal(v_b[a].numpy(), ref_v)
        np.testing.assert_array_equal(uv_b[a].numpy()[ref_v],
                                      np.asarray(ref_uv)[ref_v])
        # nothing within `cell` px of a live existing point
        d = np.linalg.norm(uv_b[a].numpy()[ref_v][:, None]
                           - existing[a][ex_valid[a]][None], axis=-1)
        assert d.min() >= 12
