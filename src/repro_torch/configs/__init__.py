"""The dense LM configurations the port serves and trains (port of the
dense part of ``repro.configs``): each module keeps the JAX file's
``CONFIG`` (the published widths) and ``SMOKE`` (a small test size) with
the same values. The MoE configurations wait for the MoE block; the
``--arch`` names are in ``registry``."""
from . import gemma3_4b, stablelm_1_6b, tinyllama_1_1b
from .lm_family import LM_SHAPES, lm_param_count

__all__ = ["LM_CONFIGS", "LM_SHAPES", "lm_param_count"]

# name -> (CONFIG, SMOKE)
LM_CONFIGS = {m.CONFIG.name: (m.CONFIG, m.SMOKE)
              for m in (tinyllama_1_1b, stablelm_1_6b, gemma3_4b)}
