"""Many-pair workloads over the registration pipeline.

Counterpart of ``pyfocusr_tpu/parallel/``: only ``cohort`` is ported (one
card); ``groupwise`` and ``bigmesh`` are ROADMAP Queue 1 item 9.
"""
