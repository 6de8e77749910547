"""The port's examples (pebblesdr_tpu_torch/examples/, the counterparts of
examples/01-05) run once each on the CPU at the JAX examples' sizes, their
outcome checked: the written audio and a steady S-meter (01), the channels
on a station (02), pilot lock, separation and the PS name "TPU FM  " (03),
the bank's stations with the first one active (04), the DTMF digits
"2468" and the CTCSS squelch open (05); and without --device cpu each
stops, naming the device, where there is no card."""

import importlib

import pytest
import torch

EXAMPLES = ("ex01_file_playback", "ex02_channelizer", "ex03_wfm_rds",
            "ex04_station_bank", "ex05_interactive_and_decoders")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the chain's ops are small, and the suite runs
    several workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def example(name: str):
    return importlib.import_module(f"pebblesdr_tpu_torch.examples.{name}")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_on_the_cpu(name, tmp_path):
    mod = example(name)
    argv = ["--device", "cpu"]
    if name == "ex01_file_playback":
        argv += ["--out", str(tmp_path)]
    res = mod.main(argv)
    mod.check(res)


def test_outcomes_are_checked():
    """Each check refuses a wrong outcome."""
    bad = {"ex02_channelizer": dict(hot=[0, 9], nearest=[0, 9, 18]),
           "ex03_wfm_rds": dict(pilot_locked=True, separation_db=35.0,
                                ps="TPU FN  ", callsign="WAAA", blocks_ok=20,
                                block_errors=0),
           "ex05_interactive_and_decoders": dict(
               digits="246", ctcss_first_open=14,
               events=["SQL -10 dB", "SQL -7 dB"])}
    for name, res in bad.items():
        with pytest.raises(RuntimeError):
            example(name).check(res)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_a_card_without_device_cpu(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        example(name).main([])
    assert exc.value.code != 0
    assert "--device cuda: no CUDA device" in capsys.readouterr().err
