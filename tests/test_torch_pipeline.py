"""The port's ring pipeline (pebblesdr_tpu_torch/parallel/pipeline.py) in
one 4-rank gloo world on the CPU (a 4-stage "stage" mesh), mirroring
tests/test_pipeline.py with its bounds: the pipelined AM chain against the
sequential composition of its stages, outputs and every stage's state 1e-6
(on every rank: the last stage's output and the owners' states reach all);
one 4-block run against two 2-block runs, 1e-6; against the monolithic
staged Receiver's step, 1e-5; a Receiver whose front is K1 refused; a mesh
of the wrong size refused.  And the pipelined audio against the JAX
package's RingPipeline on 4 forced CPU devices, within the port's
Receiver parity bound 2e-4 (tests/test_chain_batched.py:58)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist as td
from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu.parallel import pipeline as jpipe
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.parallel import pipeline

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 devices")

KW = dict(sample_rate=td.PIPE["fs"], frames_per_buffer=td.PIPE["n"],
          channels=td.PIPE["c"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return td.World("pipeline", 4, tmp_path_factory.mktemp("pipeline"))


def test_matches_sequential(world):
    for r in world.results():
        assert r["ys"].shape == (6, td.PIPE["c"], r["seq"].shape[-1])
        np.testing.assert_allclose(r["ys"], r["seq"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["states"], r["seq_states"], rtol=0,
                                   atol=1e-6)


def test_streaming_across_runs(world):
    for r in world.results():
        np.testing.assert_allclose(r["once"], r["twice"], rtol=0, atol=1e-6)


def test_matches_receiver_step(world):
    for r in world.results():
        np.testing.assert_allclose(r["y5"], r["rx5"], rtol=0, atol=1e-5)


def test_matches_jax_pipeline(world):
    jrx = JaxReceiver(JaxConfig(mode=JaxMode.AM, use_pallas=False, **KW))
    params = jrx.default_params(100_000.0)
    stages, init = jpipe.am_chain_stages(jrx, params)
    pipe = jpipe.RingPipeline(stages, jpipe.stage_mesh(len(stages)))
    _, ys = pipe.run(init, jnp.asarray(td.pipe_blocks(5)))
    for r in world.results():
        np.testing.assert_allclose(r["y5"], np.asarray(ys), atol=2e-4)


def test_k1_receiver_rejected():
    """The fused front (K1) keeps its state lane-packed: refused loudly."""
    rx = Receiver(ReceiverConfig(mode=DemodMode.AM, **KW), "cpu")
    assert not rx.staged
    with pytest.raises(ValueError, match="staged front"):
        pipeline.am_chain_stages(rx, rx.default_params(0.0))


def test_mesh_size_validation(world):
    for r in world.results():
        assert "one per stage" in str(r["size_check"])
