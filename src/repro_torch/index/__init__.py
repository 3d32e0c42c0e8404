"""The port's application-facing index API."""
from .facade import IndexConfig, StringIndex

__all__ = ["IndexConfig", "StringIndex"]
