"""Graphs and the paper's GNN models (numpy copies of ``repro.gnn``)."""
from . import graphs, models  # noqa: F401
