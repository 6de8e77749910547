"""The port's command-line receiver (``python -m
pebblesdr_tpu_torch.serve.cli``)."""
