"""The exception a task's failed check raises
(geosongpu_tpu/harness/exceptions.py)."""


class CICheckException(Exception):
    """Raised when a task's check() gate fails."""
