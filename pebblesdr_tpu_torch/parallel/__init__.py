"""Multi-rank execution on torch.distributed: the port of pebblesdr_tpu/parallel/.

JAX's shard_map bodies become functions that one rank runs on its own
shard of a (channel x time) mesh of ranks (mesh.py); comm.py makes every
collective.  time_shard.py and channelizer.py shard one capture's time axis
(K1 per time shard on the card), expert.py routes channels to per-mode
Receivers, pfb_shard.py shards the filterbank bank, dist_fft.py one FFT,
pipeline.py the chain's stages, multihost.py brings a launcher's world up,
scaling.py accounts for the traffic.
"""
