"""Many-pair workloads over the registration pipeline.

Counterpart of ``pyfocusr_tpu/parallel/``: ``cohort`` and ``groupwise``
on one card; ``bigmesh`` and every ``device_mesh`` are ROADMAP Queue 1
item 9.
"""
