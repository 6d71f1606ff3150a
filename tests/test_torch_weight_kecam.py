"""The four kecam-family members (EfficientNetV2T, EfficientNetV1B4,
ResNest50, ECA_NFNetL0) through the Keras-h5 route, as
``test_torch_weight_members.py`` takes the other three: each narrow, a
Keras-layout ``.h5`` written from the JAX model's variables tree by the
inverse of ``map_kecam`` (valid only if the JAX package's
``convert_keras_h5`` gives it back), the port's conversion equal to the JAX package's bit for
bit, and the port's f32 forward from the file within 1e-4 of JAX's."""
import pytest

from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_weight_members import (KECAM, check_conversion, check_forward, check_writer,
                                       member_files)  # noqa: F401  (a fixture)


@pytest.mark.parametrize("name", KECAM)
def test_writer_is_the_inverse_of_the_jax_mapper(member_files, name):  # noqa: F811
    check_writer(member_files, name)


@pytest.mark.parametrize("name", KECAM)
def test_h5_conversion_equals_jax(member_files, name):  # noqa: F811
    check_conversion(member_files, name)


@pytest.mark.parametrize("name", KECAM)
def test_h5_forward_matches_jax(member_files, name):  # noqa: F811
    check_forward(member_files, name)
