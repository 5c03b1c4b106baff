"""Optimizer of the LM trainer: AdamW with global-norm clipping and
optional 8-bit moments (``adamw.py``), the WSD schedule (``schedule.py``)."""
from .adamw import AdamWState, adamw_init, adamw_update  # noqa: F401
from .schedule import wsd_schedule  # noqa: F401
