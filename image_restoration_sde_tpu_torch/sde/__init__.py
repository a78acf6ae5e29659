from . import rng, samplers
from .denoising_sde import DenoisingSDE
from .irsde import IRSDE
from .schedules import ScheduleTables, build_tables, make_theta_schedule

__all__ = ["DenoisingSDE", "IRSDE", "ScheduleTables", "build_tables", "make_theta_schedule", "rng", "samplers"]
