"""BaM core: cache, queues, coalescer, storage tier and ``BamArray``.

Import the modules directly (``repro_torch.core.bam_array`` and so on);
this package file imports nothing, so the kernels' plain versions can use
``core.ssd`` without an import cycle.
"""
