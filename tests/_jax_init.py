"""One compile of a JAX model's init per configuration in a test process.

``vip_cup_2022_tpu.models.create_model`` jits ``module.init`` afresh on
every call, so each test that builds the same narrow model compiles its init
again (a narrow GCViTTiny at 224 takes about 17 s on the CPU, most of it
that compile). :func:`jax_model` keeps the jitted init of each configuration
and returns what ``create_model`` returns: the same program on the same key
draws the same variables. The head's activation and the block path
(``fused_block``) create no leaf and draw nothing, so configurations that
differ only in those share one compile.
"""
import jax
import jax.numpy as jnp

from vip_cup_2022_tpu.models import create_model as jax_create_model

_INITS = {}
_NO_LEAVES = ("classifier_activation", "fused_block")


def jax_model(name: str, rng=None, **kw):
    """``(module, variables, cfg)`` as ``create_model(name, rng=rng, **kw)``
    gives them, the init compiled once per configuration."""
    module, _, cfg = jax_create_model(name, init=False, **kw)
    key = (name, tuple(sorted((k, repr(v)) for k, v in kw.items() if k not in _NO_LEAVES)))
    if key not in _INITS:
        _INITS[key] = jax.jit(module.init)
    dummy = jnp.zeros((1, *cfg.input_size, cfg.in_channels), jnp.float32)
    rng = rng if rng is not None else jax.random.PRNGKey(0)
    return module, _INITS[key](rng, dummy), cfg
