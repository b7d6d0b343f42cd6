"""The configurations the port serves and trains (port of
``repro.configs``): each LM module keeps the JAX file's ``CONFIG`` (the
published widths) and ``SMOKE`` (a small test size) with the same values,
for the three dense LMs and the two MoE ones; the recsys modules and
gin-tu keep JAX's ``CONFIG`` and a ``smoke()`` that calls their family's
(``recsys_family`` and ``gnn_family`` hold their shapes, FLOP counts and
smoke steps). The ``--arch`` names are in ``registry``, and every arch
module's ``get_arch()`` gives its ``ArchSpec`` (``common``: its cells,
abstract arguments, specs and rank programs, which ``launch.dryrun``
traces)."""
from . import (gemma3_4b, granite_moe_1b, olmoe_1b_7b, stablelm_1_6b,
               tinyllama_1_1b)
from .common import ArchSpec, ShapeDef
from .lm_family import LM_SHAPES, lm_param_count, shape_config
from .registry import all_arch_names, get_arch

__all__ = ["LM_CONFIGS", "LM_SHAPES", "lm_param_count", "shape_config",
           "get_arch", "all_arch_names", "ArchSpec", "ShapeDef"]

# name -> (CONFIG, SMOKE)
LM_CONFIGS = {m.CONFIG.name: (m.CONFIG, m.SMOKE)
              for m in (tinyllama_1_1b, stablelm_1_6b, gemma3_4b,
                        granite_moe_1b, olmoe_1b_7b)}
