"""The port's bench (pebblesdr_tpu_torch/tools/bench.py) against bench.py,
and the cell machinery it shares with chip_smoke.py (tools/cells.py).

bench.py is loaded by path: at the top it imports only numpy, and these
cases never reach its JAX imports.  Both benches read their knobs from the
environment when loaded, so each case loads both under its own
environment.  The port runs on the CPU here (BENCH_DEVICE=cpu); its timing
windows and row arithmetic are held to bench.py's on one fake clock, its
matrix plan to what bench.main() asks for, and one real CPU row runs in a
subprocess.
"""

import ast
import importlib.util
import json
import os
import pkgutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pebblesdr_tpu.ops import pallas_kernels as pk
from pebblesdr_tpu_torch.chain import receiver
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import front, wfm_tail
from pebblesdr_tpu_torch.tools import cells

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pebblesdr_tpu_torch" / "tools" / "bench.py"
KNOBS = ("BENCH_MODE", "BENCH_CHANNELS", "BENCH_BLOCKS", "BENCH_STEPS",
         "BENCH_FRAMES", "BENCH_FS", "BENCH_AGC_STRIDE",
         "BENCH_SPECTRA_EVERY", "BENCH_AB", "BENCH_PFB_BANK",
         "BENCH_PFB_STATIONS", "BENCH_ROW_TIMEOUT", "BENCH_I16",
         "BENCH_DEVICE", "BENCH_PROFILE")
# bench.py's row keys and the digits it rounds each to
ROW_DIGITS = {"msps_per_chip": 1, "realtime_per_channel": 1, "block_ms": 3,
              "compile_warmup_s": 1, "window_spread": 2, "vs_baseline": 1}
AB_DIGITS = {"a_msps": 1, "b_msps": 1, "b_over_a_ratio": 4,
             "ratio_spread": 3}
RESULT_KEYS = {"metric", "value", "unit", "vs_baseline", "matrix",
               "total_bench_s", "device"}


def load(monkeypatch, path: Path, name: str, **env):
    """The module at path, loaded afresh under `name` with the bench
    knobs unset but for env (BENCH_DEVICE=cpu unless env says)."""
    for key in KNOBS:
        monkeypatch.delenv(key, raising=False)
    for key, v in {"BENCH_DEVICE": "cpu", **env}.items():
        if v is not None:
            monkeypatch.setenv(key, v)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def both(monkeypatch, **env):
    """(bench.py, the port's bench), each loaded under env."""
    return (load(monkeypatch, ROOT / "bench.py", "jax_bench", **env),
            load(monkeypatch, PORT, "port_bench", **env))


def fake_clock(monkeypatch, durations):
    """time.perf_counter giving each window (two readings) its duration."""
    ticks, t = [], 100.0
    for d in durations:
        ticks += [t, t + d]
        t += d + 1.0
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def bench_py_plane(jb, mode: str, frames: int, channels: int) -> np.ndarray:
    """The [N, 2C] float32 plane bench.py's _build_runner ships."""
    iq = jb._synth_iq(mode, frames)
    return np.concatenate([
        np.broadcast_to(iq.real.astype(np.float32)[:, None],
                        (frames, channels)),
        np.broadcast_to(iq.imag.astype(np.float32)[:, None],
                        (frames, channels))], axis=1)


@pytest.mark.parametrize("mode", ["am", "wfm"])
def test_synth_iq_planes_are_bench_pys_bits(monkeypatch, mode):
    jb, pb = both(monkeypatch)
    want = bench_py_plane(jb, mode, 4096, 16)
    got = pb._synth_iq(mode, 4096, 16)
    assert got.dtype == np.float32 and got.shape == (4096, 32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    fold = front.pick_fold(16, 64)
    assert fold == 4
    assert np.array_equal(front.fold_plane_np(np.tile(got, (fold, 1)), fold),
                          pk.fold_plane_np(np.tile(want, (fold, 1)), fold))


def row_plan(monkeypatch, mod) -> list:
    """The (mode, channels, blocks, steps) of every row mod.main() asks
    for, its _row_subprocess replaced by a recorder."""
    calls = []

    def record(mode, channels=None, blocks=None, steps=None, timeout_s=None,
               retries=1):
        calls.append((mode, channels, blocks, steps))
        return {"config": mode, "msps_per_chip": 1.0, "vs_baseline": 1.0}

    monkeypatch.setattr(mod, "_row_subprocess", record)
    mod.main()
    return calls


@pytest.mark.parametrize("env", [{}, {"BENCH_STEPS": "8",
                                      "BENCH_BLOCKS": "4"}])
def test_matrix_plan_is_bench_pys(monkeypatch, capsys, env):
    jb, pb = both(monkeypatch, **env)
    want = row_plan(monkeypatch, jb)
    got = row_plan(monkeypatch, pb)
    assert len(want) == 12 and got == want
    port_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(port_line) == RESULT_KEYS
    assert [r["config"] for r in port_line["matrix"]] == [c[0] for c in want]
    assert port_line["device"] == {"platform": "cpu"}


@pytest.mark.parametrize("durations,count", [
    ([1.0, 1.2, 1.1], 3),                              # all within 1.5x
    ([1.0, 2.0, 1.1, 0.9, 0.95, 1.0], 6),              # > 1.5x, then calm
    ([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], 6),               # always > 1.5x
])
def test_timed_windows_match_bench_py(monkeypatch, durations, count):
    jb, pb = both(monkeypatch)
    fake_clock(monkeypatch, durations + [9.0] * 6)
    want = jb._timed_windows(lambda i: None, lambda out: 0.0, 5)
    fake_clock(monkeypatch, durations + [9.0] * 6)
    got = pb._timed_windows(lambda i: None, lambda: None, 5)
    assert len(want[1]) == count
    assert got[0] == pytest.approx(want[0], abs=1e-12)
    assert got[1] == pytest.approx(want[1], abs=1e-12)


def test_row_arithmetic_matches_bench_py(monkeypatch):
    jb, pb = both(monkeypatch)
    monkeypatch.setattr(jb, "_build_runner", lambda *a, **k: (
        lambda i: None, lambda out: 0.0, {}, 2.5))
    monkeypatch.setattr(pb, "_build_runner", lambda *a, **k: (
        lambda i: None, lambda: None, lambda: {}, 2.5))
    windows = [0.61, 1.05, 0.58, 0.6, 0.7, 0.59]
    fake_clock(monkeypatch, windows)
    want = jb.bench_receiver("am", 64, 32, 40)
    fake_clock(monkeypatch, windows)
    got = pb.bench_receiver("am", 64, 32, 40)
    assert got["config"] == want["config"] == "am_64ch"
    for key, digits in ROW_DIGITS.items():
        assert round(got[key], digits) == want[key], key
    assert [round(w, 3) for w in got["windows_s"]] == want["windows_s"]

    pairs = [0.5, 0.55, 0.52, 0.5, 0.49, 0.6, 0.51, 0.53]
    fake_clock(monkeypatch, pairs)
    want = jb.bench_ab("am", "am_i16", 256, 16, 20)
    fake_clock(monkeypatch, pairs)
    got = pb.bench_ab("am", "am_i16", 256, 16, 20)
    assert got["config"] == want["config"]
    for key, digits in AB_DIGITS.items():
        assert round(got[key], digits) == want[key], key
    assert [[round(v, 3) for v in p] for p in got["pairs_s"]] == \
        want["pairs_s"]


@pytest.mark.parametrize("channels", [1, 2, 4, 8, 16, 32, 64, 256])
def test_pick_fold_is_the_jax_rule(channels):
    for k in (1, 2, 4, 16, 32, 64):
        assert front.pick_fold(channels, k) == pk.pick_fold(channels, k)


def test_cpu_row_in_a_subprocess():
    """One am row on the CPU through `python -m`.  K = 8 blocks of 8192
    frames: at K = 2 the last dispatch's audio (8 ms, 70 ms into the run)
    sits inside the AM DC blocker's start-up and reads 33 dB, under the
    row's 40 dB tone check."""
    env = dict(os.environ, BENCH_DEVICE="cpu", BENCH_MODE="am",
               BENCH_CHANNELS="2", BENCH_FRAMES="8192", BENCH_BLOCKS="8",
               BENCH_STEPS="2")
    proc = subprocess.run([sys.executable, "-m",
                           "pebblesdr_tpu_torch.tools.bench"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    result = json.loads(lines[0])
    assert set(result) == RESULT_KEYS
    assert result["device"] == {"platform": "cpu"}
    (row,) = result["matrix"]
    assert "error" not in row, row
    assert set(ROW_DIGITS) | {"config", "windows_s"} <= set(row)
    assert row["config"] == "am_2ch" and row["device"] == "cpu"
    assert len(row["windows_s"]) >= 3
    assert row["k1_per_dispatch"] == 0 and row["peak_gib"] is None
    assert result["value"] == row["msps_per_chip"] > 0


def test_a_row_counts_only_its_own_launches(monkeypatch):
    """Launch counts left by earlier work in the process (here set by
    hand; on the card, any kernel call before the row) are not the row's:
    an in-process row starts its counts at 0 and passes its launch check."""
    pb = load(monkeypatch, PORT, "port_bench")
    monkeypatch.setattr(front.fused_front, "launches", 7)
    monkeypatch.setattr(front.chunk_means, "launches", 7)
    monkeypatch.setattr(wfm_tail.wfm_tail, "launches", 3)
    row = pb.bench_receiver("am", 2, 8, 2, frames=8192)
    assert "error" not in row, row
    assert row["k1_per_dispatch"] == row["k2_per_dispatch"] == 0


def test_a_profiled_row_needs_a_card(monkeypatch):
    pb = load(monkeypatch, PORT, "port_bench", BENCH_PROFILE="1")
    with pytest.raises(RuntimeError, match="BENCH_PROFILE needs a CUDA"):
        pb.bench_receiver("am", 2, 2, 1, frames=8192)


def test_a_row_that_times_out_or_dies_becomes_an_error_row(monkeypatch,
                                                           capsys):
    pb = load(monkeypatch, PORT, "port_bench")
    calls = []

    def fake_run(cmd, cwd, env, capture_output, text, timeout):
        mode = env["BENCH_MODE"]
        calls.append(mode)
        if mode == "wfm_rds":
            raise subprocess.TimeoutExpired(cmd, timeout, stderr="stuck\n")
        if mode == "sam":
            return subprocess.CompletedProcess(cmd, 1, "", "Traceback\n")
        row = {"config": mode, "msps_per_chip": 1.0, "vs_baseline": 1.0}
        return subprocess.CompletedProcess(
            cmd, 0, json.dumps({"matrix": [row]}) + "\n", "")

    monkeypatch.setattr(subprocess, "run", fake_run)
    pb.main()
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = result["matrix"]
    assert len(rows) == 12
    assert calls.count("wfm_rds") == 2 and calls.count("sam") == 2
    assert "timed out" in rows[2]["error"] and "msps_per_chip" not in rows[2]
    assert "exit code 1" in rows[4]["error"]
    assert all("error" not in r for i, r in enumerate(rows) if i not in (2, 4))
    assert result["value"] == 1.0


def test_no_card_raises(monkeypatch):
    """No card (torch sees none, nvidia-smi is not there): a row, the
    matrix (which asks nvidia-smi before it starts a row) and run_one
    raise unless BENCH_DEVICE=cpu; no row process is started."""
    def no_smi(cmd, *a, **k):
        if cmd[0] == "nvidia-smi":
            raise FileNotFoundError(cmd[0])
        raise AssertionError(f"started {cmd}")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(subprocess, "run", no_smi)
    for device in (None, "cuda", "cuda:0"):
        for mode in ("am", "matrix"):
            pb = load(monkeypatch, PORT, "port_bench", BENCH_DEVICE=device,
                      BENCH_MODE=mode)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pb.main()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pb.run_one("am")


# ---- the cell machinery moved into the package (tools/cells.py) ----------

def imported_names(path: Path) -> set:
    """The top-level names of every module path's AST imports, anywhere in
    the file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_port_imports_chip_smoke():
    paths = sorted((ROOT / "pebblesdr_tpu_torch").rglob("*.py"))
    assert ROOT / "pebblesdr_tpu_torch" / "tools" / "cells.py" in paths
    for path in paths:
        names = imported_names(path)
        assert "chip_smoke" not in names, path
        assert not names & {"jax", "pebblesdr_tpu"}, path
    assert not imported_names(ROOT / "chip_smoke.py") & {"jax",
                                                         "pebblesdr_tpu"}


def test_the_no_jax_import_test_walks_the_bench_and_the_cells():
    """tests/test_torch_receiver.py test_port_imports_no_jax imports every
    module pkgutil.walk_packages finds in the package."""
    import pebblesdr_tpu_torch as pkg
    found = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")}
    assert {"pebblesdr_tpu_torch.tools.bench",
            "pebblesdr_tpu_torch.tools.cells"} <= found


@pytest.mark.parametrize("mode,channels,blocks,entry,fold", [
    ("am", 16, 8, "fold4", 4), ("wfm", 4, 2, "f32", 1)])
def test_make_cell_plane_is_the_bench_plane(monkeypatch, mode, channels,
                                            blocks, entry, fold):
    jb = load(monkeypatch, ROOT / "bench.py", "jax_bench")
    demod = DemodMode.FMS if mode == "wfm" else DemodMode.AM
    cell = cells.make_cell(torch, receiver, front, demod, "tiny", channels,
                           blocks, entry, frames=8192, device="cpu")
    block = bench_py_plane(jb, mode, 8192, channels)
    if fold > 1:
        block = pk.fold_plane_np(np.tile(block, (fold, 1)), fold)
    want = np.tile(block, (blocks // fold, 1))
    assert cell["iq"].device.type == "cpu"
    assert torch.equal(cell["iq"], torch.from_numpy(want))


def test_make_cell_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cells.make_cell(torch, receiver, front, DemodMode.AM, "tiny", 2, 2,
                        frames=8192)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cells.make_bank_cell(torch, blocks=1, stations=3, bank=16,
                             frames=8192)


def test_check_cell_on_the_cpu_counts_no_launch():
    """A CPU cell runs the plain versions, which never count: check_cell
    holds it to zero launches, and a launch it did not expect fails."""
    cell = cells.make_cell(torch, receiver, front, DemodMode.AM, "tiny", 2,
                           8, frames=8192, device="cpu")
    cells.reset_launches(front, wfm_tail)
    for _ in range(cells.WARMUP + 6):
        cells.dispatch(cell)
    cells.count_launches(cell, front, wfm_tail)
    assert cells.check_cell(torch, cell, "cpu") == (0,) * 8
    assert cell["snr_db"] >= cells.TONE_SNR_DB
    cell["launches"][0] += cell["i"]
    with pytest.raises(RuntimeError, match="launches"):
        cells.check_cell(torch, cell, "cpu")


def test_the_registry_is_perf_md_section_4():
    """The named cells and their shapes, as PERF.md section 4's table lists
    them (cell, mode, channels, blocks, frames, entry)."""
    text = (ROOT / "PERF.md").read_text()
    section = text[text.index("\n## 4."):text.index("\n## 5.")]
    rows = [[c.strip().strip("`") for c in line.strip("|").split("|")]
            for line in section.splitlines() if line.startswith("| `")]
    listed = {r[0]: (r[1], int(r[2]), int(r[3]), int(r[4]), r[5])
              for r in rows}
    assert listed == {name: (s.mode, s.channels, s.blocks, s.frames,
                             s.entry) for name, s in cells.CELLS.items()}
