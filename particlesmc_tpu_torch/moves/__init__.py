from .base import Move, displacement, init_pool_params, pool_probabilities
