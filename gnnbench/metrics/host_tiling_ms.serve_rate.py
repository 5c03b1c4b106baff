"""``host_tiling_ms.serve``, read in the serving cells whose end-to-end metric is
the served rate."""
from gnnbench.cell import HERE, import_file

read = import_file(HERE / "metrics" / "host_tiling_ms.serve.py").read
