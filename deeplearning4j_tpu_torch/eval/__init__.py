"""Evaluation (counterpart of ``deeplearning4j_tpu/eval/``)."""
