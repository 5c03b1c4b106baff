"""The trainer's token pipeline (``pipeline.py``)."""
from .pipeline import TokenPipeline  # noqa: F401
