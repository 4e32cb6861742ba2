from .densities import SIGMA_DENSITIES, make_sample_density
from .precond import denoiser_forward, denoiser_loss, edm_scalings
from .samplers import SAMPLERS, log_likelihood, sample_loop
from .schedules import NOISE_SCHEDULES, get_noise_schedule

__all__ = ["denoiser_forward", "denoiser_loss", "edm_scalings",
           "SIGMA_DENSITIES", "make_sample_density", "SAMPLERS", "sample_loop",
           "log_likelihood",
           "NOISE_SCHEDULES", "get_noise_schedule"]
