"""The profiling examples (the counterparts of ``examples/prof``): each
runs as ``python -m apex_tpu_torch.examples.prof.<name>``, on the card
by default and on the CPU with ``--device cpu``."""
