"""Host-side IQ input and audio output of the port (numpy copies of
pebblesdr_tpu/io)."""
