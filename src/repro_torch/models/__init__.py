"""LM model stack for the assigned architecture pool (the port of
:mod:`repro.models`)."""
from .transformer import LMModel

__all__ = ["LMModel"]
