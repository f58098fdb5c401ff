from .callbacks import CALLBACK_REGISTRY
from .schedule import build_schedule
from .simulation import Algorithm, Simulation, run
