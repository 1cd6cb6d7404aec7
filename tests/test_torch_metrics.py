"""PyTorch port (``bcfl_tpu_torch``): the reference's run surface against
the JAX package and psutil, on the CPU.

- ``ResourceMonitor`` reads the process without psutil: its resident set
  lies within 4 pages of the psutil ``memory_info().rss`` readings taken
  just before and just after it, and its windowed CPU percent is psutil's
  ``cpu_percent(None)`` over the same busy window within 10 points (both
  count clock ticks of 10 ms); its
  ``start_sampling`` emits ``resource`` events with the fields of JAX's
  psutil sampler;
- ``RunMetrics.to_json``: every key is one of JAX's, at the top level and
  in each round, with the same values for the same records; ``summary``
  prints the same resource lines as JAX's, and ``format_report`` carries
  them;
- ``run_sweep`` over 2 and 3 clients writes ``<name>_sweep.json`` and the
  three figures, and ``--sweep`` runs the 5/10/20-client sweep from the
  command line.
"""

import dataclasses
import json
import os
import time

import pytest
import torch

from bcfl_tpu.metrics import metrics as jm
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.config import FedConfig, PartitionConfig
from bcfl_tpu_torch.entrypoints.__main__ import main as cli_main
from bcfl_tpu_torch.entrypoints.presets import SWEEP_CLIENTS
from bcfl_tpu_torch.entrypoints.run import format_report, run, run_sweep
from bcfl_tpu_torch.metrics import metrics as tm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel workers: at these tiny shapes torch's intra-op threads only
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(**kw):
    base = dict(dataset="synthetic", model="tiny-bert", num_clients=2,
                num_rounds=2, seq_len=16, batch_size=4, max_local_batches=2,
                vocab_size=512, max_eval_batches=2, mode="serverless",
                partition=PartitionConfig(kind="iid", iid_samples=8),
                compression=CompressionConfig(kind="int8+topk"))
    base.update(kw)
    return FedConfig(**base)


# ------------------------------------------------------- ResourceMonitor


def test_rss_matches_psutil():
    """The port's reading lies between two psutil readings taken just
    before and just after it (within 4 pages): a worker's other threads
    (a transport's senders, a sampler, torch's pools) may allocate between
    any two reads, so a single pair can drift apart by more than the
    reading's own error; the bracket holds whatever they do in between
    as long as the resident set only grows or only shrinks across it."""
    import psutil

    page = os.sysconf("SC_PAGE_SIZE")
    proc = psutil.Process()
    readings = []
    blob = None
    for _ in range(2):
        before = proc.memory_info().rss
        a = tm._rss_bytes()
        after = proc.memory_info().rss
        lo, hi = min(before, after), max(before, after)
        assert lo - 4 * page <= a <= hi + 4 * page, (before, a, after)
        readings.append(a)
        if blob is None:  # the reading moves with the process
            blob = bytearray(64 << 20)
            blob[::page] = b"\x01" * len(blob[::page])
    assert readings[1] >= readings[0] + (32 << 20)
    del blob


def test_cpu_percent_matches_psutil_over_a_busy_window():
    import psutil

    proc = psutil.Process()
    proc.cpu_percent(None)  # prime, as both monitors do
    mon = tm.ResourceMonitor()
    t0 = time.monotonic()
    x = 0
    while time.monotonic() - t0 < 0.6:  # busy on this thread only
        x += 1
    busy, want = mon.snapshot(), proc.cpu_percent(None)
    assert abs(busy["cpu_percent"] - want) <= 10.0, (busy, want)
    assert 0.6 / 60 <= busy["latency_min"] < 0.7 / 60 + 0.1
    assert set(busy) == {"cpu_percent", "memory_gb", "latency_min"}
    # windowed: a second reading covers only the time since the first
    time.sleep(0.6)
    idle, want = mon.snapshot(), proc.cpu_percent(None)
    assert abs(idle["cpu_percent"] - want) <= 10.0, (idle, want)
    assert idle["cpu_percent"] < busy["cpu_percent"]


def test_disk_free_bytes():
    import shutil

    assert tm.ResourceMonitor().disk_free_bytes() is None
    free = tm.ResourceMonitor(run_dir=".").disk_free_bytes()
    assert abs(free - shutil.disk_usage(".").free) < 1 << 30
    assert tm.ResourceMonitor(run_dir="/no/such/dir").disk_free_bytes() is None


@pytest.mark.parametrize("run_dir", [None, "."])
def test_sampling_emits_jax_resource_events(tmp_path, run_dir):
    """``start_sampling`` emits the ``resource`` event with the fields of
    JAX's sampler (psutil there), idempotently, and ``stop_sampling``
    ends it; without an installed writer the emit is a no-op."""
    from bcfl_tpu import telemetry as jtel
    from bcfl_tpu_torch import telemetry as ttel

    def sample(tel, mon, path):
        tel.install(tel.EventWriter(str(path), peer=0, run="x"))
        try:
            assert mon.start_sampling(0.05)
            assert not mon.start_sampling(0.05)  # already running
            time.sleep(0.4)
            mon.stop_sampling()
            mon.stop_sampling()
        finally:
            tel.flush()
            tel.uninstall()
        return [e for e in map(json.loads, open(path))
                if e["ev"] == "resource"]

    got = sample(ttel, tm.ResourceMonitor(run_dir=run_dir),
                 tmp_path / "t.jsonl")
    want = sample(jtel, jm.ResourceMonitor(run_dir=run_dir),
                  tmp_path / "j.jsonl")
    assert got and want
    assert {tuple(sorted(e)) for e in got} == {tuple(sorted(e))
                                               for e in want}
    assert all(e["interval_s"] == 0.05 and e["rss_gb"] > 0 for e in got)
    n = len(got)
    time.sleep(0.15)
    assert not tm.ResourceMonitor().start_sampling(0.0)
    assert len([e for e in map(json.loads, open(tmp_path / "t.jsonl"))
                if e["ev"] == "resource"]) == n  # stopped


# ------------------------------------------------- to_json, summary, report


@pytest.fixture(scope="module")
def cpu_run():
    from bcfl_tpu_torch.config import LedgerConfig

    return run(_tiny(ledger=LedgerConfig(enabled=True)), device="cpu",
               verbose=False)


def _jax_twin(m):
    """The JAX ``RunMetrics`` holding the same records and rollups."""
    rounds = [jm.RoundRecord(**dataclasses.asdict(r)) for r in m.rounds]
    return jm.RunMetrics(rounds=rounds, model_size_gb=m.model_size_gb,
                         resources=dict(m.resources), ledger=dict(m.ledger),
                         phases=dict(m.phases), comms=dict(m.comms))


def test_to_json_keys_and_values_match_jax(cpu_run):
    m = cpu_run.metrics
    assert set(m.resources) == {"cpu_percent", "memory_gb", "latency_min"}
    assert m.resources["latency_min"] > 0
    got, want = json.loads(m.to_json()), json.loads(_jax_twin(m).to_json())
    assert set(got) <= set(want)
    for key in got:
        if key != "rounds":
            assert got[key] == want[key], key
    assert len(got["rounds"]) == len(want["rounds"]) == 2
    for g, w in zip(got["rounds"], want["rounds"]):
        assert set(g) <= set(w)
        assert {k: w[k] for k in g} == g
    assert got["ledger"]["chain_ok"] == 1.0


def test_summary_and_report_resource_lines(cpu_run):
    m = cpu_run.metrics
    assert m.summary() == _jax_twin(m).summary()
    report = format_report(cpu_run).splitlines()
    for k, v in m.resources.items():
        assert f"{k}: {v:.3f}" in report


# ------------------------------------------------------------------ sweep


def test_run_sweep_writes_json_and_figures(tmp_path):
    cfg = _tiny(name="tiny_sweep", num_rounds=1)
    out = run_sweep(cfg, [2, 3], device="cpu", verbose=False,
                    out_dir=str(tmp_path))
    assert sorted(out) == [2, 3]
    assert [len(out[n].metrics.rounds[0].local_acc) for n in (2, 3)] == [2, 3]
    rec = json.loads((tmp_path / "tiny_sweep_sweep.json").read_text())
    assert rec["counts"] == [2, 3] and rec["mode"] == "serverless"
    assert rec["model"] == "tiny-bert" and rec["rounds"] == 1
    for n in ("2", "3"):
        r = rec["runs"][n]
        assert 0.0 <= r["final_acc"] <= 1.0 and r["latency_min"] > 0
        assert r["memory_gb"] == out[int(n)].metrics.resources["memory_gb"]
    for fig in ("latency", "accuracy", "memory"):
        assert (tmp_path / f"tiny_sweep_sweep_{fig}.png").stat().st_size > 0
    # each count checkpoints into its own c<n> subdirectory
    ck = tmp_path / "ck"
    run_sweep(cfg.replace(checkpoint_dir=str(ck), checkpoint_every=1), [2],
              device="cpu", verbose=False, out_dir=None)
    assert sorted(p.name for p in ck.iterdir()) == ["c2"]
    assert (ck / "c2" / "round_000000" / "state.pt").is_file()


def test_cli_sweep(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli_main(["--preset", "smoke", "--device", "cpu", "--sweep",
                     "--rounds", "1", "--seq-len", "16",
                     "--max-local-batches", "1", "--eval-every", "0"]) == 0
    out = capsys.readouterr().out
    assert out.count("== smoke_c") == len(SWEEP_CLIENTS) == 3
    rec = json.loads((tmp_path / "results" / "smoke_sweep.json").read_text())
    assert rec["counts"] == SWEEP_CLIENTS == [5, 10, 20]
    assert "sweep artifacts:" in out and "cpu_percent:" in out


def test_port_needs_no_pandas_psutil_or_eager_matplotlib():
    """The card's machine has none of pandas, psutil or matplotlib: the
    port imports the first two nowhere, and matplotlib only inside the
    functions of ``viz/`` that draw."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "bcfl_tpu_torch"
    seen_mpl = False
    for f in sorted(root.rglob("*.py")):
        tree = ast.parse(f.read_text(), filename=str(f))
        top = set(tree.body)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                pkg = name.split(".")[0]
                assert pkg not in ("pandas", "psutil"), f"{f}: {name}"
                if pkg == "matplotlib":
                    seen_mpl = True
                    assert f.parent.name == "viz" and node not in top, (
                        f"{f}: matplotlib imported outside a viz function")
    assert seen_mpl
