"""The port's data layer (counterpart of ``vip_cup_2022_tpu/data/``): the
JPEG decode pool, the inference batch loader and host resize, the training
and eval loaders of the custom-JSON route, RandAugment / AutoAugment and
the augment ops on the device, and ``tfds.init_dataset``."""
from .augment import apply_augment  # noqa: F401
from .decode import ImageDecoder, decode_image  # noqa: F401
from .pipeline import BatchLoader, build_dataset, seeding  # noqa: F401
from .randaugment import auto_augment, rand_augment  # noqa: F401
from .train_pipeline import (  # noqa: F401
    EvalLoader,
    TrainLoader,
    loaders_from_custom_json,
    recognition_dataset_from_custom_json,
)
