"""Parity module for reference ``pyfocusr/main.py`` (banner printing);
counterpart of ``pyfocusr_tpu/main.py``."""

from .utils.logging import print_header

__all__ = ["print_header"]
