"""LM substrate of the port: parameter templates, GQA/MLA attention, the
routed MoE layer and the dense/moe model assembly (``lm.py``)."""
