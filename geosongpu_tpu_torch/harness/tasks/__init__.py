"""Task classes register themselves when imported."""
from . import baroclinic  # noqa: F401
