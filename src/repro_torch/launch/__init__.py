"""Command-line launchers (port of ``src/repro/launch/``)."""
