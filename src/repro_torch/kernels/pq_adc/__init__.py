"""Fused PQ ADC-gather scan (kernel K1): LUT quantization, the plain
PyTorch version, and the wrapper that launches the CUDA kernel."""
from .lut import (LUT_DTYPES, center_lut, lut_error_bound, quantize_lut,
                  snap_lut, snap_values)
from .ops import pq_adc_gather_topk
from .ref import pq_adc_gather_scores_ref, pq_adc_gather_topk_ref

__all__ = ["LUT_DTYPES", "center_lut", "lut_error_bound", "quantize_lut",
           "snap_lut", "snap_values", "pq_adc_gather_topk",
           "pq_adc_gather_scores_ref", "pq_adc_gather_topk_ref"]
