"""One module a configuration family, ``systems/<system>.py``, named by a
configuration's ``system``: ``System()`` with ``build(run)`` (the port's
entry point on the run's weights), ``noise_shape(run, batch, H, W)`` (one
draw of the chain) and ``reference_call(ref, x, noise, mode, steps)`` (the
plain reference computing the same call)."""
