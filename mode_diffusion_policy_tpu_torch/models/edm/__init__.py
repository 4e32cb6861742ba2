from .precond import denoiser_forward, edm_scalings
from .samplers import SAMPLERS, sample_loop
from .schedules import NOISE_SCHEDULES, get_noise_schedule

__all__ = ["denoiser_forward", "edm_scalings", "SAMPLERS", "sample_loop",
           "NOISE_SCHEDULES", "get_noise_schedule"]
