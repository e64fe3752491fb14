"""Test support: deterministic fault injection (:mod:`.chaos`; counterpart
of ``deeplearning4j_tpu/testing/``)."""

from .chaos import CHAOS_PLAN_ENV, ChaosSource, FaultPlan, corrupt_file, truncate_file

__all__ = ["CHAOS_PLAN_ENV", "ChaosSource", "FaultPlan", "corrupt_file",
           "truncate_file"]
