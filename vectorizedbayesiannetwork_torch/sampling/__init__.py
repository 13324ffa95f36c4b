"""Samplers (registered on import): ancestral, Gibbs, HMC and NUTS."""

from . import ancestral  # noqa: F401
from . import gibbs  # noqa: F401
from . import hmc  # noqa: F401
from . import nuts  # noqa: F401
