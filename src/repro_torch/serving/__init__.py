"""Serving engine, phase profiles and KV accounting (port of
``src/repro/serving/``)."""
