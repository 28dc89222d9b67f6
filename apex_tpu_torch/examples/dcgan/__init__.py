"""DCGAN training with amp (``python -m
apex_tpu_torch.examples.dcgan.main_amp``)."""
