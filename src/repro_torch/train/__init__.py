"""Training substrate, so far the data pipeline and the prefill/decode step
builders; the train step and the optimizer come with the training slice."""

from .data import synthetic_batch
from .step import build_decode_step, build_prefill_step

__all__ = ["synthetic_batch", "build_decode_step", "build_prefill_step"]
