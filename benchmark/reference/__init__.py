"""Plain float32 PyTorch references of the benchmark's configurations.

Frozen copies of the published architectures, written for this benchmark:
they import nothing of ``image_restoration_sde_tpu_torch`` (kernels, plain
versions and oracles included) and nothing of JAX.  Each configuration has
a file of its own, ``<config>.py``, that builds its networks from the
configuration file; ``nets.py`` holds the layers, ``sde.py`` the IR-SDE
chains, ``precision.py`` the rounding that puts
the reference in a lower precision (the control of ``correct``).
"""
