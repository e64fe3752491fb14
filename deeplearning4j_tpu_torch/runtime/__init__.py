"""Runtime of the port (counterpart of ``deeplearning4j_tpu/runtime``): the
captured training steps of the staged loop (``step_graphs``)."""
