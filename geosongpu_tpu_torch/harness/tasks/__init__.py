"""Task classes register themselves when imported."""
from . import aquaplanet  # noqa: F401
from . import baroclinic  # noqa: F401
from . import climatology  # noqa: F401
from . import held_suarez  # noqa: F401
from . import physics_standalone  # noqa: F401
