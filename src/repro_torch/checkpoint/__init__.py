"""Checkpoints (port of ``src/repro/checkpoint/``): :mod:`.store`, the
atomic on-disk format the reference reads and writes leaf for leaf, and
:mod:`.manager`, the asynchronous writer with retention."""
