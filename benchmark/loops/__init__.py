"""One module a loop, ``loops/<loop>.py``, named by a traffic mix's
``loop``: ``Loop(cell, seed, device, system, reference)``, a
``cells.Run`` with ``setup()``, ``window(seconds)``, ``traced(record)``,
``free()`` and ``check()``.  The mix's other keys are the loop's
parameters."""
