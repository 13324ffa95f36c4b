"""Online update policies (registered on import)."""

from . import policies  # noqa: F401
from .base_update import BaseUpdatePolicy, resolve_node_update

__all__ = ["BaseUpdatePolicy", "resolve_node_update"]
