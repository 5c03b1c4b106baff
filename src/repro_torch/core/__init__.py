"""Compiler front end (numpy copies of ``repro.core``) and the PyTorch
engines: :mod:`.executor` (oracle) and :mod:`.pipeline` (tiled runner)."""
