"""Digital-mode modems of the PyTorch port (port of pebblesdr_tpu/modem/)."""
