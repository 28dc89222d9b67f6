"""ImageNet training with amp (``python -m
apex_tpu_torch.examples.imagenet.main_amp``)."""
