"""PQ ADC scans: LUT quantization, the plain PyTorch versions, and the
wrappers that launch the CUDA kernels K1 (fused ADC-gather top-k over
per-query candidates) and K2 (ADC top-k over one shared code matrix)."""
from .lut import (LUT_DTYPES, center_lut, lut_error_bound, quantize_lut,
                  snap_lut, snap_values)
from .ops import (pq_adc_gather_topk, pq_adc_gather_topk_plain, pq_adc_topk,
                  pq_adc_topk_plain)
from .ref import (pq_adc_gather_scores_ref, pq_adc_gather_topk_ref,
                  pq_adc_scores_ref, pq_adc_topk_ref)

__all__ = ["LUT_DTYPES", "center_lut", "lut_error_bound", "quantize_lut",
           "snap_lut", "snap_values", "pq_adc_gather_topk",
           "pq_adc_gather_topk_plain", "pq_adc_topk", "pq_adc_topk_plain",
           "pq_adc_gather_scores_ref", "pq_adc_gather_topk_ref",
           "pq_adc_scores_ref", "pq_adc_topk_ref"]
