"""Seconds from the run's start to the synchronisation after set-up: the
port's import, any kernel build, weights and inputs made on the card,
the captures of the cell's own shapes and their first replay."""


def read(ctx):
    return ctx.setup_s
