"""The port's optimizers against optax through the JAX package's factory,
its weight-decay mask against the JAX one, and SAM, on the CPU.

Each optimizer runs 3 steps on a Flax-named tree (kernels, biases, norm
scales, a rel-pos table, a layer scale) with the same gradients on both
sides, built at learning rate 1 with the updates times the lr, as both
trainers do; each step's updates and the parameters after it agree within
1e-6 of the leaf's max|ref| (f32 on both sides, the same element-wise
formulas in another library)."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from vip_cup_2022_tpu.models import create_model as jax_create_model
from vip_cup_2022_tpu.train import create_optimizer as jax_create_optimizer
from vip_cup_2022_tpu.train import sam_gradient as jax_sam_gradient
from vip_cup_2022_tpu.train import weight_decay_mask as jax_weight_decay_mask
from vip_cup_2022_tpu_torch.models import create_model
from vip_cup_2022_tpu_torch.train import TrainConfig, Trainer
from vip_cup_2022_tpu_torch.train.optimizers import OPTIMIZERS, create_optimizer, weight_decay_mask
from vip_cup_2022_tpu_torch.train.sam import sam_gradient
from vip_cup_2022_tpu_torch.weights.to_flax import torch_to_flax

REL = 1e-6
LR = 0.05


def _tree(rng):
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    return {
        "stem": {"kernel": u(3, 3, 4, 8), "bias": u(8)},
        "norm": {"gamma": u(8) + 1.5, "beta": u(8)},
        "dense": {"kernel": u(8, 5), "bias": u(5)},
        "attn": {"relative_position_bias_table": u(9, 2)},
        "blk": {"gamma1": u(8), "dw": {"kernel": u(3, 3, 1, 8)}},
        "zero": {"kernel": np.zeros((4, 4), np.float32)},  # LAMB's zero-norm rule
    }


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("decay", [0.0, 0.1])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name, decay, clip):
    rng = np.random.RandomState(len(name))
    tree = _tree(rng)
    grads = [jax.tree_util.tree_map(lambda p: rng.normal(0, 1, p.shape).astype(np.float32), tree)
             for _ in range(3)]
    tx = jax_create_optimizer(name, 1.0, weight_decay=decay, momentum=0.9, grad_clip_norm=clip)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = tx.init(jparams)
    mask = _flat(weight_decay_mask(tree))
    ours = create_optimizer(name, weight_decay=decay, momentum=0.9, grad_clip_norm=clip,
                            mask=mask)
    params = {k: torch.from_numpy(v.copy()) for k, v in _flat(tree).items()}
    state = ours.init(params)
    for g in grads:
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        updates = jax.tree_util.tree_map(lambda u: u * jnp.float32(LR), updates)
        jparams = optax.apply_updates(jparams, updates)
        got, state = ours.update({k: torch.from_numpy(v) for k, v in _flat(g).items()}, state,
                                 params)
        for k in params:
            params[k] = params[k] + got[k] * LR
        for k, want in _flat(jax.tree_util.tree_map(np.asarray, updates)).items():
            scale = max(np.abs(want).max(), 1e-30)
            assert np.abs(got[k].numpy() * LR - want).max() <= REL * scale, (k, name)
        for k, want in _flat(jax.tree_util.tree_map(np.asarray, jparams)).items():
            scale = max(np.abs(want).max(), 1e-30)
            assert np.abs(params[k].numpy() - want).max() <= REL * scale, (k, name)
    assert int(state["count"]) == 3


def test_weight_decay_mask_equals_jax_on_a_tree():
    tree = _tree(np.random.RandomState(0))
    assert weight_decay_mask(tree) == jax.tree_util.tree_map(bool, jax_weight_decay_mask(tree))


def test_weight_decay_mask_of_gcvit_is_jax_and_keeps_the_linears():
    """On GCViT's Flax names (through the inverse bridge) the mask is the JAX
    one; the trainer's mask by torch name decays every Linear and conv
    weight, though "weight" is on the exempt list (Flax calls them
    kernels)."""
    kw = dict(dim=32, num_heads=(1, 2, 4, 8), depths=(2, 2, 2, 2), nb_classes=1,
              classifier_activation=None)
    module, _, _ = jax_create_model("GCViTTiny", input_size=(224, 224), init=False, **kw)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    want = jax_weight_decay_mask(flax.core.unfreeze(shapes)["params"])
    port, _ = create_model("GCViTTiny", input_size=(224, 224), **kw)
    assert weight_decay_mask(torch_to_flax(port)["params"]) == jax.tree_util.tree_map(bool, want)
    tr = Trainer(port, TrainConfig(weight_decay=1e-4), device="cpu")
    decayed = {k for k, v in tr.decay_mask.items() if v}
    assert "levels_0.blocks_0.attn.qkv.weight" in decayed
    assert "levels_0.blocks_0.mlp.fc1.weight" in decayed
    assert "patch_embed.proj.weight" in decayed
    assert "patch_embed.conv_down.conv_0.weight" in decayed  # the depthwise taps
    assert not decayed & {"levels_0.blocks_0.attn.relative_position_bias_table",
                          "levels_0.blocks_0.norm1.weight", "levels_0.blocks_0.attn.qkv.bias"}
    assert len(decayed) == sum(jax.tree_util.tree_leaves(want))


def test_sam_gradient_matches_jax():
    """The second pass's gradient at p + rho g / ||g||, the parameters put
    back after."""
    w0 = np.array([0.5, 1.0, -2.0, 0.25], np.float32)
    b0 = np.array([0.3], np.float32)

    def jax_loss(p):
        return jnp.sum(jnp.sin(p["w"]) * p["b"][0] + p["w"] ** 2), None

    (jl, _), jg = jax_sam_gradient(jax_loss, {"w": jnp.asarray(w0), "b": jnp.asarray(b0)},
                                   rho=0.5, has_aux=True)
    params = {"w": torch.tensor(w0, requires_grad=True), "b": torch.tensor(b0, requires_grad=True)}
    loss, grads = sam_gradient(
        lambda: torch.sum(torch.sin(params["w"]) * params["b"][0] + params["w"] ** 2), params, 0.5)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jg[k]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(params["w"].detach().numpy(), w0)


def test_sam_gradient_returns_the_second_pass_state():
    """A buffer each pass moves in place (as BN's running statistics) holds
    the second pass's update from its start, as the JAX step returns the
    second pass's statistics."""
    p = {"w": torch.tensor([1.0, 2.0], requires_grad=True)}
    buf = torch.zeros(2)
    seen = []

    def loss_fn():
        with torch.no_grad():
            seen.append(buf.clone())
            buf.copy_(0.9 * buf + 0.1 * p["w"])
        return (p["w"] ** 2).sum()

    sam_gradient(loss_fn, p, rho=1.0, state={"buf": buf})
    assert torch.equal(seen[0], seen[1])  # both passes start from the same state
    w_adv = torch.tensor([1.0, 2.0]) * (1 + 1.0 / torch.tensor([1.0, 2.0]).norm())
    torch.testing.assert_close(buf, 0.1 * w_adv)
