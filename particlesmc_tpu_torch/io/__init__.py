from . import formats
from .loader import Chains, load_chains, load_configuration
