"""Causal-LM pretraining with amp (``python -m
apex_tpu_torch.examples.lm.main_amp``)."""
