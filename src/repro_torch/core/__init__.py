"""MPAD/QPAD fitting in PyTorch (the port of ``repro.core``)."""
from .mpad import MPADConfig, MPADResult, fit_mpad, transform

__all__ = ["MPADConfig", "MPADResult", "fit_mpad", "transform"]
