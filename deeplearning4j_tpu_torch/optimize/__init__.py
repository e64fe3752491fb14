"""Listeners and batch solvers (counterpart of ``deeplearning4j_tpu/optimize/``)."""
