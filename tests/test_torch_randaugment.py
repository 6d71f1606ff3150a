"""The port's RandAugment / AutoAugment (``data/randaugment.py``) against the
JAX package's, on the CPU, in f32.

Every op of the table, on the same seeded images with the same per-image
arguments: within 1e-4 of the [0, 255] range (f32 sums in another order;
the warps' coordinates and cos / sin one ulp apart), ``equalize`` and
``posterize`` exactly (integer math on the same truncated values).

``rand_augment`` and ``auto_augment`` (each of the four policies) on draws
made the JAX way (the JAX functions' key splits replayed with
``jax.random``): within 1e-4 of [0, 1] on every pixel except where an
integer cast (``posterize``, ``equalize``) after an earlier op meets a
value within 1e-4 of an integer, where one ulp decides the level. The
tests find those pixels from the port's own intermediates (the draws cut
after each layer), require every pixel outside the bound to be one of
them, print their count and hold it to 0.1 % of the pixels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.data import randaugment as J
from vip_cup_2022_tpu_torch.data import randaugment as R

TOL = 1e-4  # of the range: 1e-4 * 255 in the 0-255 domain, 1e-4 in [0, 1]
B, H, W = 6, 36, 44
N_AUG = 48  # images for the policies: most ops and sub-policies drawn
CAST_OPS = {"posterize", "equalize", "Posterize", "Equalize"}


def _u(rng, lo, hi, n=B):
    return rng.uniform(lo, hi, n).astype(np.float32)


# name: (JAX op on one HWC image with its argument, port op on the batch,
# the per-image argument drawn from a RandomState, or None)
OPS = {
    "autocontrast": (lambda x, a: J.autocontrast(x), lambda x, a: R.autocontrast(x), None),
    "equalize": (lambda x, a: J.equalize(x), lambda x, a: R.equalize(x), None),
    "invert": (lambda x, a: J.invert(x), lambda x, a: R.invert(x), None),
    "posterize": (J.posterize, R.posterize, lambda r: r.randint(0, 9, B).astype(np.float32)),
    "solarize": (J.solarize, R.solarize, lambda r: _u(r, 0, 256)),
    "solarize_add": (J.solarize_add, R.solarize_add, lambda r: _u(r, 0, 110)),
    "color": (J.color, R.color, lambda r: _u(r, 0.1, 1.9)),
    "contrast": (J.contrast, R.contrast, lambda r: _u(r, 0.1, 1.9)),
    "brightness": (J.brightness, R.brightness, lambda r: _u(r, 0.1, 1.9)),
    "sharpness": (J.sharpness, R.sharpness, lambda r: _u(r, 0.1, 1.9)),
    "rotate": (J.rotate, R.rotate, lambda r: _u(r, -30, 30)),
    "shear_x": (J.shear_x, R.shear_x, lambda r: _u(r, -0.3, 0.3)),
    "shear_y": (J.shear_y, R.shear_y, lambda r: _u(r, -0.3, 0.3)),
    "translate_x": (J.translate_x, R.translate_x, lambda r: _u(r, -20, 20)),
    "translate_y": (J.translate_y, R.translate_y, lambda r: _u(r, -20, 20)),
}
EXACT = ("equalize", "posterize")


@pytest.fixture(scope="module")
def op_cases():
    """Per op: float images in [0, 255], integer-valued ones, the argument,
    and JAX's outputs on both."""
    rng = np.random.RandomState(0)
    img = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    img[0, :, :, 1] = 77.0  # a flat channel: autocontrast / equalize leave it
    img_int = np.floor(img)
    cases = {}
    for name, (jop, _, draw) in OPS.items():
        arg = None if draw is None else draw(rng)
        fn = jax.jit(jax.vmap(lambda x, a, jop=jop: jop(x, a)))
        a = jnp.zeros(B) if arg is None else jnp.asarray(arg)
        cases[name] = (arg, [(x, np.asarray(fn(jnp.asarray(x), a))) for x in (img, img_int)])
    fn = jax.jit(jax.vmap(lambda x, k: J.cutout(k, x, 9)))
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    cut = np.asarray(fn(jnp.asarray(img), keys))
    centres = np.stack([[int(jax.random.randint(k2, (), 0, n))
                         for k2, n in zip(jax.random.split(k), (H, W))] for k in keys])
    cases["cutout"] = (centres, [(img, cut)])
    return cases


@pytest.mark.parametrize("name", list(OPS) + ["cutout"])
def test_op_matches_jax(op_cases, name):
    arg, pairs = op_cases[name]
    for x, want in pairs:
        if name == "cutout":
            got = R.cutout(torch.from_numpy(x), 9, torch.from_numpy(arg[:, 0]),
                           torch.from_numpy(arg[:, 1])).numpy()
        else:
            a = None if arg is None else torch.from_numpy(arg)
            got = OPS[name][1](torch.from_numpy(x), a).numpy()
        if name in EXACT or name == "cutout":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL * 255, err_msg=name)


def test_ops_take_python_numbers(op_cases):
    """A number stands for every image's argument."""
    x = torch.from_numpy(op_cases["rotate"][1][0][0])
    for fn, v in ((R.rotate, 12.5), (R.posterize, 3.0), (R.solarize, 100.0),
                  (R.color, 1.4), (R.translate_y, -7.0)):
        np.testing.assert_array_equal(fn(x, v).numpy(), fn(x, torch.full((B,), v)).numpy())


# ---------------------------------------------------------------------------
# the policies on JAX's draws
# ---------------------------------------------------------------------------


def jax_rand_draws(rng, b, h, w, num_layers, magnitude, magnitude_std, apply_probability,
                   use_cutout) -> R.RandAugmentDraws:
    """``rand_augment``'s draws, its key splits replayed (:294-311)."""

    def layer(key):
        k_op, k_mag, k_gate, k_apply = jax.random.split(key, 4)
        k_sign, _ = jax.random.split(k_apply)
        return (jax.random.randint(k_op, (), 0, len(J.RAND_AUG_OPS)),
                jnp.clip(magnitude + magnitude_std * jax.random.normal(k_mag), 0.0, J._MAX_LEVEL),
                jax.random.uniform(k_gate) < apply_probability,
                jnp.where(jax.random.uniform(k_sign) < 0.5, -1.0, 1.0))

    def per_image(key):
        ky, kx = jax.random.split(jax.random.fold_in(key, 7))
        centre = jnp.stack([jax.random.randint(ky, (), 0, h), jax.random.randint(kx, (), 0, w)])
        return jax.vmap(layer)(jax.random.split(key, num_layers)), centre

    (op, level, gate, sign), centre = jax.jit(jax.vmap(per_image))(jax.random.split(rng, b))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return R.RandAugmentDraws(t(op).long(), t(level), t(gate), t(sign),
                              t(centre).long() if use_cutout else None)


def jax_auto_draws(rng, b, policy) -> R.AutoAugmentDraws:
    """``auto_augment``'s draws, its key splits replayed (:414-433)."""
    subs = J.AUTOAUGMENT_POLICIES[policy]
    probs = jnp.asarray([[p for _, p, _ in sub] for sub in subs])

    def per_image(key):
        k_sel, k_ops = jax.random.split(key)
        idx = jax.random.randint(k_sel, (), 0, len(subs))
        gate, sign = [], []
        for i in range(2):
            k_gate, k_op = jax.random.split(jax.random.fold_in(k_ops, i))
            gate.append(jax.random.uniform(k_gate) < probs[idx, i])
            sign.append(jnp.where(jax.random.uniform(k_op) < 0.5, -1.0, 1.0))
        return idx, jnp.stack(gate), jnp.stack(sign)

    sub, gate, sign = jax.jit(jax.vmap(per_image))(jax.random.split(rng, b))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return R.AutoAugmentDraws(t(sub).long(), t(gate), t(sign))


def _near_integer(x255: np.ndarray) -> np.ndarray:
    return np.abs(x255 - np.rint(x255)) <= TOL


def boundary_pixels(stages, cast_at) -> np.ndarray:
    """Pixels (B, H, W, C) where a cast meets a value within 1e-4 of an
    integer: ``stages[i]`` is the port's image in [0, 1] before op ``i``
    and ``cast_at[i]`` (B,) says which images cast there; posterize's cast
    is per pixel, equalize's histogram reaches the whole channel (only
    from the second op on: before it both sides hold the same values)."""
    mask = np.zeros(stages[0].shape, bool)
    for i in range(1, len(stages)):
        near = _near_integer(stages[i] * 255.0)
        kind = cast_at[i]
        post = (kind == 1)[:, None, None, None] & near
        equ = (kind == 2)[:, None, None, None] & near.any(axis=(1, 2), keepdims=True)
        mask |= post | equ
    return mask


def check_with_boundaries(label, got, want, boundary):
    bad = np.abs(got - want) > TOL
    n_boundary = int((bad & boundary).sum())
    print(f"{label}: {n_boundary} boundary pixels of {got.size} differ by more than {TOL:g} "
          f"(max |d| {np.abs(got - want).max():.3g})")
    assert not (bad & ~boundary).any(), (
        f"{label}: {int((bad & ~boundary).sum())} pixels off by up to "
        f"{np.abs(got - want)[bad & ~boundary].max():.3g} outside the boundaries")
    assert n_boundary <= 1e-3 * got.size


def _cast_kind(names) -> np.ndarray:
    return np.array([1 if n in ("posterize", "Posterize") else
                     2 if n in ("equalize", "Equalize") else 0 for n in names])


@pytest.fixture(scope="module")
def aug_images():
    return np.random.RandomState(1).uniform(0, 1, (N_AUG, 32, 28, 3)).astype(np.float32)


RAND_CASES = {  # (num_layers, magnitude, magnitude_std, apply_probability, use_cutout)
    "m9_cutout": (2, 9.0, 0.5, 0.8, True),
    "m6_three_layers": (3, 6.0, 0.5, 0.5, False),
}


@pytest.fixture(scope="module")
def rand_cases(aug_images):
    out = {}
    for seed, (label, (nl, mag, std, prob, cut)) in enumerate(RAND_CASES.items()):
        rng = jax.random.PRNGKey(10 + seed)
        want = np.asarray(jax.jit(lambda k, x, nl=nl, mag=mag, std=std, prob=prob, cut=cut:
                                  J.rand_augment(k, x, num_layers=nl, magnitude=mag,
                                                 magnitude_std=std, apply_probability=prob,
                                                 use_cutout=cut))(rng, jnp.asarray(aug_images)))
        draws = jax_rand_draws(rng, N_AUG, 32, 28, nl, mag, std, prob, cut)
        out[label] = (draws, want)
    return out


@pytest.mark.parametrize("label", list(RAND_CASES))
def test_rand_augment_matches_jax_on_its_draws(aug_images, rand_cases, label):
    draws, want = rand_cases[label]
    x = torch.from_numpy(aug_images)
    got = R.rand_augment(x, draws).numpy()
    layers = draws.op.shape[1]
    stages, cast_at = [], []
    for i in range(layers):
        cut = R.RandAugmentDraws(*(t[:, :i] for t in draws[:4]))
        stages.append(R.rand_augment(x, cut).numpy() if i else aug_images)
        names = [R.RAND_AUG_OPS[k] if g else "" for k, g in
                 zip(draws.op[:, i].tolist(), draws.gate[:, i].tolist())]
        cast_at.append(_cast_kind(names))
    check_with_boundaries(f"rand_augment {label}", got, want, boundary_pixels(stages, cast_at))
    assert len(set(draws.op[draws.gate].tolist())) >= 12  # most of the table ran


@pytest.fixture(scope="module")
def auto_cases(aug_images):
    out = {}
    for seed, policy in enumerate(J.AUTOAUGMENT_POLICIES):
        rng = jax.random.PRNGKey(20 + seed)
        want = np.asarray(jax.jit(lambda k, x, p=policy: J.auto_augment(k, x, policy=p))(
            rng, jnp.asarray(aug_images)))
        out[policy] = (jax_auto_draws(rng, N_AUG, policy), want)
    return out


@pytest.mark.parametrize("policy", ["v0", "simple", "positional", "test"])
def test_auto_augment_matches_jax_on_its_draws(aug_images, auto_cases, policy):
    draws, want = auto_cases[policy]
    x = torch.from_numpy(aug_images)
    got = R.auto_augment(x, draws, policy).numpy()
    subs = R.AUTOAUGMENT_POLICIES[policy]
    first = R.AutoAugmentDraws(draws.sub, draws.gate & torch.tensor([True, False]), draws.sign)
    stages = [aug_images, R.auto_augment(x, first, policy).numpy()]
    cast_at = [np.zeros(N_AUG, int), _cast_kind([
        subs[k][1][0] if g else "" for k, g in zip(draws.sub.tolist(), draws.gate[:, 1].tolist())])]
    check_with_boundaries(f"auto_augment {policy}", got, want, boundary_pixels(stages, cast_at))
    if policy == "v0":
        assert len(set(draws.sub.tolist())) >= 20


def test_draws_are_seeded_and_shaped():
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = R.draw_rand_augment(g(), 5, (16, 20), num_layers=3, use_cutout=True)
    b = R.draw_rand_augment(g(), 5, (16, 20), num_layers=3, use_cutout=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.op.shape == a.level.shape == a.gate.shape == a.sign.shape == (5, 3)
    assert a.cutout.shape == (5, 2) and (a.cutout[:, 0] < 16).all() and (a.cutout[:, 1] < 20).all()
    assert ((a.level >= 0) & (a.level <= 10)).all()
    assert set(a.sign.flatten().tolist()) <= {-1.0, 1.0}
    d = R.draw_auto_augment(g(), 40, "v0")
    assert d.sub.max() < 25 and d.gate.shape == d.sign.shape == (40, 2)
    # a sub-policy op at probability 0 never runs
    zero = [i for i, s in enumerate(R.AUTOAUGMENT_POLICIES["v0"]) if s[1][1] == 0.0]
    assert not d.gate[torch.isin(d.sub, torch.tensor(zero)), 1].any()
    with pytest.raises(ValueError, match="unknown policy"):
        R.draw_auto_augment(g(), 2, "v9")
