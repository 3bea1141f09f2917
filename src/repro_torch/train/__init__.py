"""Training on one card: AdamW (``optimizer``) and the train, prefill and
decode steps (``steps``). Gradient compression comes with the LM over ranks."""
from . import optimizer, steps  # noqa: F401
