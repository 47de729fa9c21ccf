"""Offline tooling over the port's serving engine: `sim/replay.py`
re-executes capture logs (`obs/capture.py`) and triages divergences."""
