from . import rng, samplers
from .irsde import IRSDE
from .schedules import ScheduleTables, build_tables, make_theta_schedule

__all__ = ["IRSDE", "ScheduleTables", "build_tables", "make_theta_schedule", "rng", "samplers"]
