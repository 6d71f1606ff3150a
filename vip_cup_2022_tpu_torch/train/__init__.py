"""Training (counterpart of ``vip_cup_2022_tpu/train/``): losses, lr
schedules, optimizers mirroring optax, mixup / cutmix, SAM, the metric
logger, token labels, the trainer and its history tools
(``train/history.py``, imported on its own as in the JAX package)."""
from .logging import MetricLogger  # noqa: F401
from .losses import (  # noqa: F401
    balanced_accuracy,
    binary_accuracy,
    binary_cross_entropy_timm,
    categorical_cross_entropy,
    distill_kl_divergence,
)
from .mixup import cutmix, mixup, mixup_cutmix  # noqa: F401
from .token_label import build_token_labels, token_label_align  # noqa: F401
from .optimizers import create_optimizer, weight_decay_mask  # noqa: F401
from .sam import sam_gradient  # noqa: F401
from .schedules import (  # noqa: F401
    CosineLrScheduler,
    constant_scheduler,
    cosine_decay,
    cosine_decay_restarts,
    exp_scheduler,
    multistep_schedule,
)
from .trainer import TrainConfig, Trainer  # noqa: F401
