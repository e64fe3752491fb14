"""Runtime of the port (counterpart of ``deeplearning4j_tpu/runtime``): the
process-wide cache of captured programs (``compile_manager``), the captured
training steps of the staged loop (``step_graphs``) and the bucketed
inference path replayed as CUDA graphs (``inference``)."""
