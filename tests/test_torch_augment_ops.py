"""The port's training augment ops (``data/augment.py``) against the JAX
package's, on the CPU, in f32, on draws made the JAX way (each op's key
splits replayed with ``jax.random``).

``random_bgr`` exactly; ``random_jitter``, ``blur`` and
``shift_scale_shear_rotate`` within 1e-4 of the [0, 1] range;
``jpeg_roundtrip`` / ``random_jpeg_quality`` within 1e-4 except the
pixels of an 8 x 8 block (16 x 16 for the subsampled chroma) where a
quantised coefficient lies within 1e-4 of a rounding boundary (found from
the port's own coefficients): they are counted, printed and held to
0.1 % of the pixels; ``jpeg_compress_host`` (cv2 with the caller's ``RandomState``)
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.data import augment as J
from vip_cup_2022_tpu_torch.data import augment as P

TOL = 1e-4
B, H, W = 8, 36, 44  # neither side a multiple of 16: the JPEG path pads
QUALITIES = [10, 35, 49, 50, 75, 90, 95, 100]  # both branches of libjpeg's scaling


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).uniform(0, 1, (B, H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_outputs(images):
    """Each JAX op on the images with its key, and the draws its splits give."""
    x = jnp.asarray(images)
    out = {}
    k = jax.random.PRNGKey(1)
    out["bgr"] = (np.asarray(J.random_bgr(k, x, 0.5)),
                  np.asarray(jax.random.uniform(k, (B,)) < 0.5))
    k = jax.random.PRNGKey(2)
    keys = jax.random.split(k, 6)
    u = lambda key, lo, hi: np.asarray(jax.random.uniform(key, (B,), minval=lo, maxval=hi))  # noqa
    draws = P.JitterDraws(_t(u(keys[0], 0, 1) < 0.6), _t(u(keys[1], -0.1, 0.1)),
                          _t(u(keys[2], 0.8, 1.2)), _t(u(keys[3], 0.8, 1.2)),
                          _t(u(keys[4], -0.1, 0.1)))
    out["jitter"] = (np.asarray(jax.jit(lambda k, x: J.random_jitter(k, x, prob=0.6))(k, x)),
                     draws)
    k = jax.random.PRNGKey(3)
    out["blur"] = (np.asarray(jax.jit(lambda k, x: J.blur(k, x, 3, prob=0.5))(k, x)),
                   np.asarray(jax.random.uniform(k, (B,)) < 0.5))
    out["blur5"] = (np.asarray(jax.jit(lambda k, x: J.blur(k, x, 4, prob=1.0))(k, x)),
                    np.ones(B, bool))
    k = jax.random.PRNGKey(4)
    keys = jax.random.split(k, 7)
    normal = np.stack([np.asarray(jax.random.normal(keys[i], (B,))) for i in range(1, 7)], 1)
    out["affine"] = (np.asarray(jax.jit(lambda k, x: J.shift_scale_shear_rotate(k, x, prob=0.7))(
        k, x)), P.AffineDraws(_t(np.asarray(jax.random.uniform(keys[0], (B,))) < 0.7),
                              _t(normal)))
    out["jpeg"] = np.asarray(jax.jit(jax.vmap(J.jpeg_roundtrip))(
        x, jnp.asarray(QUALITIES, jnp.float32)))
    k = jax.random.PRNGKey(5)
    k_gate, k_q = jax.random.split(k)
    out["random_jpeg"] = (
        np.asarray(jax.jit(lambda k, x: J.random_jpeg_quality(k, x, (60, 95), 0.5))(k, x)),
        np.asarray(jax.random.uniform(k_gate, (B,)) < 0.5),
        np.asarray(jax.random.randint(k_q, (B,), 60, 96)))
    return out


def test_random_bgr_equals_jax(images, jax_outputs):
    want, mask = jax_outputs["bgr"]
    assert 0 < mask.sum() < B
    np.testing.assert_array_equal(P.random_bgr(_t(images), _t(mask)).numpy(), want)


def test_random_jitter_matches_jax(images, jax_outputs):
    want, draws = jax_outputs["jitter"]
    assert 0 < draws.apply.sum() < B
    got = P.random_jitter(_t(images), draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("case,size", [("blur", 3), ("blur5", 4)])
def test_blur_matches_jax(images, jax_outputs, case, size):
    want, mask = jax_outputs[case]
    got = P.blur(_t(images), _t(mask), filter_size=size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_shift_scale_shear_rotate_matches_jax(images, jax_outputs):
    want, draws = jax_outputs["affine"]
    assert 0 < draws.apply.sum() < B
    got = P.shift_scale_shear_rotate(_t(images), draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def jpeg_boundary(images: np.ndarray, qualities) -> np.ndarray:
    """The pixels (B, H, W, 3) of each block that quantises a coefficient
    within 1e-4 of a rounding boundary, from the port's coefficients."""
    x = _t(images)
    q = torch.tensor(np.asarray(qualities))
    y, cb, cr = P.jpeg_ycbcr(x)
    hp, wp = y.shape[1:]
    mask = np.zeros((x.shape[0], hp, wp), bool)

    def near(chan, base, scale):
        ratio = (P.dct_blocks(chan - 128.0) / P.jpeg_quant_table(base, q)[:, None, None]).numpy()
        frac = np.abs(ratio) - np.floor(np.abs(ratio))
        hit = (np.abs(frac - 0.5) <= TOL).any(axis=(-1, -2))  # (B, h/8, w/8)
        return hit.repeat(8 * scale, 1).repeat(8 * scale, 2)

    mask |= near(y, P.JPEG_LUMA, 1)
    for c in (cb, cr):
        mask |= near(P.chroma_420(c), P.JPEG_CHROMA, 2)
    return np.repeat(mask[:, :H, :W, None], 3, -1)


def _check(label, got, want, boundary):
    bad = np.abs(got - want) > TOL
    n = int((bad & boundary).sum())
    print(f"{label}: {n} pixels in {int(boundary.sum())} boundary pixels of {got.size} differ by "
          f"more than {TOL:g}; max |d| elsewhere "
          f"{np.abs(got - want)[~boundary].max() if (~boundary).any() else 0:.3g}")
    assert not (bad & ~boundary).any()
    assert n <= 1e-3 * got.size


def test_jpeg_roundtrip_matches_jax(images, jax_outputs):
    got = P.jpeg_roundtrip(_t(images), torch.tensor(QUALITIES)).numpy()
    _check("jpeg_roundtrip", got, jax_outputs["jpeg"], jpeg_boundary(images, QUALITIES))


def test_random_jpeg_quality_matches_jax(images, jax_outputs):
    want, gate, qs = jax_outputs["random_jpeg"]
    assert 0 < gate.sum() < B
    got = P.random_jpeg_quality(_t(images), _t(gate), _t(qs)).numpy()
    boundary = jpeg_boundary(images, qs) & gate[:, None, None, None]
    _check("random_jpeg_quality", got, want, boundary)
    np.testing.assert_array_equal(got[~gate], images[~gate])


def test_jpeg_quant_table_equals_jax():
    q = np.arange(0, 103, dtype=np.float32)
    for jb, pb in ((J._JPEG_LUMA, P.JPEG_LUMA), (J._JPEG_CHROMA, P.JPEG_CHROMA)):
        want = np.stack([np.asarray(J._jpeg_quant_table(jb, v)) for v in q])
        np.testing.assert_array_equal(P.jpeg_quant_table(pb, _t(q)).numpy(), want)


def test_jpeg_compress_host_equals_jax():
    rng = np.random.RandomState(6)
    imgs = [rng.randint(0, 256, (33, 47, 3), dtype=np.uint8) for _ in range(6)]
    a, b = np.random.RandomState(7), np.random.RandomState(7)
    got = P.jpeg_compress_host(imgs, a, (70, 95), 0.6)
    want = J.jpeg_compress_host(imgs, b, (70, 95), 0.6)
    assert a.get_state()[2] == b.get_state()[2] and (a.get_state()[1] == b.get_state()[1]).all()
    assert any(g is not i for g, i in zip(got, imgs)) and any(g is i for g, i in zip(got, imgs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_draws_are_seeded_and_shaped():
    g = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    j1, j2 = P.draw_jitter(g(), 64), P.draw_jitter(g(), 64)
    for a, b in zip(j1, j2):
        assert torch.equal(a, b) and a.shape == (64,)
    assert (j1.delta.abs() <= 0.1).all() and ((j1.contrast >= 0.8) & (j1.contrast <= 1.2)).all()
    a = P.draw_affine(g(), 16)
    assert a.apply.shape == (16,) and a.normal.shape == (16, 6)
    gate, q = P.draw_jpeg_quality(g(), 200, (85, 95))
    assert gate.dtype == torch.bool and q.min() >= 85 and q.max() == 95
