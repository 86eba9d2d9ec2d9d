"""``praline-tpu-torch`` command line."""

from .main import main

__all__ = ["main"]
