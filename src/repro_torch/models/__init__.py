"""Models of the port (port of ``repro.models``): so far the dense
decoder-only LM (its training loss and serving path), in ``transformer``
on the layers of ``layers``."""
