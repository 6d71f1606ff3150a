"""Core helpers of the port: the untyped ``Config`` attribute bag."""
from .config import Config  # noqa: F401
