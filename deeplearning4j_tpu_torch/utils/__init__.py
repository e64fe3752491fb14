"""Model serialization (counterpart of ``deeplearning4j_tpu/utils/``)."""
