"""Evaluation (counterpart of ``vip_cup_2022_tpu/eval/``): the competition's
metrics and the CSV harness. The JAX package's ``interop`` module (its
Flax-model interface) and its ``evaluation`` top-1 / top-5 loop over an
image loader are not ported (ROADMAP)."""
from .harness import evaluate_csv, parity_diff  # noqa: F401
from .metrics import balanced_accuracy_score, competition_score, top_k_accuracy  # noqa: F401
