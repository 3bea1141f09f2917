"""Training: AdamW (``optimizer``), the train, prefill and decode steps
(``steps``) and the int8 error-feedback gradient all-reduce over data ranks
(``compression``)."""
from . import compression, optimizer, steps  # noqa: F401
