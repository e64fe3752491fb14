"""Datasets of the port (counterpart of ``deeplearning4j_tpu/datasets``)."""
