"""LM serving entry points: step factories (``steps.py``) and the serving
loop (``serve.py``)."""
