from . import store  # noqa: F401
from .store import (  # noqa: F401
    CheckpointError,
    CorruptShardError,
    MissingStepError,
    SlotCheckpoint,
    TemplateMismatchError,
)
