"""Evaluation (counterpart of ``vip_cup_2022_tpu/eval/``): the competition's
metrics, the CSV harness and the top-1 / top-5 loop over an image loader.
The JAX package's ``interop`` module (its Flax-model interface) is not
ported (ROADMAP A14)."""
from .harness import evaluate_csv, evaluation, parity_diff  # noqa: F401
from .metrics import balanced_accuracy_score, competition_score, top_k_accuracy  # noqa: F401
