"""The dataset builder of the training entry points (counterpart of
``vip_cup_2022_tpu/data/tfds.py``, kecam's ``imagenet/data.py:404-504``).

``init_dataset`` takes a custom-JSON file (a name ending in ``.json``) or a
TFDS name. The JSON route hands over to the host loaders of
``train_pipeline.py`` and yields their uint8 batches (the trainer divides
by 255). The TFDS route composes the reference's pipeline in ``tf.data``:
load, shuffle, random crop and resize, flip, batching, the central-crop
eval pipeline; its batches then go through :func:`post_process_batch` on
the device: RandAugment (``magnitude`` > 0), the rescale mode's
normalisation, one-hot labels, mixup / cutmix.

``tensorflow`` and ``tensorflow_datasets`` are imported only by the TFDS
route; without ``tensorflow_datasets`` it raises ``NotImplementedError``
pointing at the custom-JSON loader, which needs neither. ``try_gcs`` and
``drop_remainder`` default to False, what the JAX package picks off a TPU
(both were static-shape needs of the TPU).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..infer.engine import default_device
from .randaugment import draw_rand_augment, rand_augment

IMAGENET_TF_RESCALE = (127.5, 127.5)  # x / 127.5 - 1
IMAGENET_TORCH_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_TORCH_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def init_mean_std_by_rescale_mode(rescale_mode):
    """``(mean, std)`` in the 0-255 domain: a given pair, ``"tf"`` (to
    [-1, 1]), ``"torch"`` (ImageNet's per-channel statistics), ``"raw"`` or
    None (as is), ``"raw01"`` (to [0, 1])."""
    if isinstance(rescale_mode, (tuple, list)):
        return float(rescale_mode[0]), float(rescale_mode[1])
    if rescale_mode == "tf":
        return IMAGENET_TF_RESCALE
    if rescale_mode == "torch":
        return np.array(IMAGENET_TORCH_MEAN, np.float32), np.array(IMAGENET_TORCH_STD, np.float32)
    if rescale_mode in ("raw", None):
        return 0.0, 1.0
    if rescale_mode == "raw01":
        return 0.0, 255.0
    raise ValueError(f"unknown rescale_mode {rescale_mode!r}")


def _load_tfds(data_name: str, try_gcs: bool):
    try:
        import tensorflow_datasets as tfds  # gated optional dependency
    except ImportError as e:
        raise NotImplementedError(
            "init_dataset with a TFDS name requires tensorflow_datasets, "
            "which is not installed; use a custom-JSON dataset "
            "(data/train_pipeline.loaders_from_custom_json) instead"
        ) from e
    return tfds.load(data_name, with_info=True, try_gcs=try_gcs)


def post_process_batch(images, labels, num_classes: int, *, train: bool,
                       rescale_mode="tf", magnitude: float = 0.0, num_layers: int = 2,
                       mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       device: Optional[torch.device] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TFDS route's batch step on ``device`` (the card unless the
    caller names another): ``images`` (B, H, W, 3) in [0, 255], through
    RandAugment at ``magnitude`` (``num_layers`` layers, training batches
    only), normalised by the rescale mode; ``labels`` (B,) class ids to
    one-hot f32; then mixup / cutmix on training batches. The draws come
    from ``generator`` (a CPU ``torch.Generator``). Returns f32 tensors on
    the device."""
    from ..train.mixup import mixup_cutmix

    device = torch.device(device) if device is not None else default_device()
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.array(images, dtype=np.float32))
    x = images.to(device=device, dtype=torch.float32)
    if train and magnitude > 0:
        draws = draw_rand_augment(generator, x.shape[0], x.shape[1:3], num_layers=num_layers,
                                  magnitude=float(magnitude))
        x = rand_augment(x / 255.0, draws) * 255.0
    mean, std = init_mean_std_by_rescale_mode(rescale_mode)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(std, dtype=torch.float32, device=device)
    x = (x - mean) / std
    ids = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=device)
    onehot = torch.nn.functional.one_hot(ids, num_classes).float()
    if train and (mixup_alpha or cutmix_alpha):
        x, onehot = mixup_cutmix(x, onehot, mixup_alpha, cutmix_alpha, generator=generator)
    return x, onehot


def init_dataset(
    data_name: str = "imagenet2012",
    input_shape: Tuple[int, int] = (224, 224),
    batch_size: int = 64,
    buffer_size: int = 1000,
    info_only: bool = False,
    mixup_alpha: float = 0.0,
    cutmix_alpha: float = 0.0,
    rescale_mode="tf",
    eval_central_crop: float = 1.0,
    random_crop_min: float = 1.0,
    resize_method: str = "bilinear",
    resize_antialias: bool = False,
    magnitude: int = 0,
    num_layers: int = 2,
    use_shuffle: bool = True,
    seed: Optional[int] = None,
    try_gcs: bool = False,
    drop_remainder: bool = False,
    device: Optional[torch.device] = None,
):
    """Returns ``(train_iter_fn, test_iter_fn, total_images, num_classes,
    steps_per_epoch)``, the iter fns re-iterable factories of ``(images,
    one-hot labels)`` batches that ``train.Trainer.fit`` takes; with
    ``info_only``, ``(total_images, num_classes, steps_per_epoch,
    num_channels)``. A ``.json`` name: the custom-JSON loaders at their
    defaults (uint8 batches; the options of the TFDS route do not apply
    there, as in the JAX package). A TFDS name: the ``tf.data`` pipeline,
    each batch through :func:`post_process_batch` on ``device`` with a
    generator seeded from ``seed``."""
    if data_name.endswith(".json"):
        from .train_pipeline import loaders_from_custom_json, recognition_dataset_from_custom_json

        splits, total_images, num_classes = recognition_dataset_from_custom_json(
            data_name, with_info=True)
        steps_per_epoch = int(np.ceil(len(splits["train"][0]) / float(batch_size)))
        if info_only:
            return total_images, num_classes, steps_per_epoch, 3
        train, test, _ = loaders_from_custom_json(data_name, batch_size=batch_size,
                                                  target_shape=tuple(input_shape[:2]))
        return (lambda: iter(train)), (lambda: iter(test)), total_images, num_classes, \
            steps_per_epoch

    dataset, info = _load_tfds(data_name, try_gcs)
    num_classes = info.features["label"].num_classes
    num_channels = info.features["image"].shape[-1]
    total_images = info.splits["train"].num_examples
    steps_per_epoch = int(np.ceil(total_images / float(batch_size)))
    if info_only:
        return total_images, num_classes, steps_per_epoch, num_channels

    import tensorflow as tf

    h, w = input_shape[:2]

    def train_pre_batch(datapoint):
        img = tf.cast(datapoint["image"], tf.float32)
        if 0.0 < random_crop_min < 1.0:
            # timm's random crop fraction (data.py:33-80)
            shape = tf.shape(img)
            area = tf.cast(shape[0] * shape[1], tf.float32)
            target = tf.random.uniform((), random_crop_min, 1.0) * area
            ratio = tf.random.uniform((), 3.0 / 4.0, 4.0 / 3.0)
            cw = tf.minimum(tf.cast(tf.sqrt(target * ratio), tf.int32), shape[1])
            ch = tf.minimum(tf.cast(tf.sqrt(target / ratio), tf.int32), shape[0])
            img = tf.image.random_crop(img, (ch, cw, tf.shape(img)[-1]))
        img = tf.image.resize(img, (h, w), method=resize_method, antialias=resize_antialias)
        img = tf.image.random_flip_left_right(img)
        return img, datapoint["label"]

    def test_pre_batch(datapoint):
        img = tf.cast(datapoint["image"], tf.float32)
        if 0.0 < eval_central_crop < 1.0:
            img = tf.image.central_crop(img, eval_central_crop)
        img = tf.image.resize(img, (h, w), method=resize_method, antialias=resize_antialias)
        return img, datapoint["label"]

    autotune = tf.data.AUTOTUNE
    train_ds = dataset["train"]
    if use_shuffle:
        train_ds = train_ds.shuffle(buffer_size, seed=seed)
    train_ds = train_ds.map(train_pre_batch, num_parallel_calls=autotune)
    train_ds = train_ds.batch(batch_size, drop_remainder=drop_remainder).prefetch(autotune)

    test_tf = dataset.get("validation", dataset.get("test", None))
    if test_tf is not None:
        test_tf = test_tf.map(test_pre_batch, num_parallel_calls=autotune)
        test_tf = test_tf.batch(batch_size, drop_remainder=drop_remainder)

    device = torch.device(device) if device is not None else default_device()
    generator = torch.Generator().manual_seed(seed or 0)
    post = dict(num_classes=num_classes, rescale_mode=rescale_mode, magnitude=magnitude,
                num_layers=num_layers, mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
                generator=generator, device=device)

    def train_iter_fn():
        for images, labels in train_ds.as_numpy_iterator():
            yield post_process_batch(images, labels, train=True, **post)

    def test_iter_fn():
        if test_tf is None:
            return
        for images, labels in test_tf.as_numpy_iterator():
            yield post_process_batch(images, labels, train=False, **post)

    return train_iter_fn, test_iter_fn, total_images, num_classes, steps_per_epoch
