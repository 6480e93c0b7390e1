"""Distributed-training harness pieces (part-port of
``src/repro/distributed/``)."""
