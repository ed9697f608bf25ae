"""The deterministic part of a configuration's load, one module per
``load`` of a configuration file: ``at(x)`` takes points (..., 3) and
returns the load there as (..., 1), in ``x``'s dtype and on its device.
Plain PyTorch: the program's linear form and the reference evaluate the
same function, as they read the same field parameters."""
