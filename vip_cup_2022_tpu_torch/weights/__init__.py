"""Weight routes into the port's modules: Keras-h5 / SavedModel /
timm-torch checkpoints -> Flax variables trees (the JAX package's
``weights`` exports), and the bridges between such a tree and a module's
``state_dict`` (:mod:`.from_jax`, :mod:`.to_flax`). The converters map
*names*, never execute foreign graphs."""

from .keras_h5 import (  # noqa: F401
    apply_weight_mapper,
    convert_keras_h5,
    read_keras_h5,
    register_weight_mapper,
)
from .savedmodel import convert_savedmodel, read_savedmodel  # noqa: F401
from .torch_pt import (  # noqa: F401
    convert_torch_weights,
    read_torch_checkpoint,
    register_torch_mapper,
)
