"""Example programs of the port (the counterparts of ``examples/``)."""
