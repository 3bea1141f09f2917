from . import pipeline  # noqa: F401
from . import shards  # noqa: F401
