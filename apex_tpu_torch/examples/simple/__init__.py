"""The minimal examples (the counterparts of ``examples/simple``)."""
