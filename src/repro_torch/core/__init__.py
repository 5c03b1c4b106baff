"""Compiler front end, planners and cost model (numpy copies of
``repro.core``) and the PyTorch engines: :mod:`.executor` (the oracle
and the tiled interpreter) and :mod:`.pipeline` (the production runner)."""
