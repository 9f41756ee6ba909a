"""Mesh file readers and writers: copies of ``pyfocusr_tpu/io``."""
