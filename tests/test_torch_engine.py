"""PyTorch port (``bcfl_tpu_torch``): the slice end to end on the CPU, its
config gate, the host-side data modules against the JAX package, and the
import boundary.

(f) ``run(..., device="cpu")`` for 2 rounds; every config value the slice
does not run raises "not ported yet"; ``run()`` without a device and
without a GPU raises instead of dropping to the CPU; an AST scan finds no
``jax``/``flax``/``optax``/``bcfl_tpu`` import in the port or in
``chip_smoke.py``. The tokenizer, the datasets (``synthetic``, ``csv:`` on
a CSV this test writes, ``medical_transcriptions``) and the contiguous
partitions are equal to the JAX package's.
"""

import ast
import math
import pathlib

import numpy as np
import pytest
import torch

from bcfl_tpu.config import PartitionConfig as JPart
from bcfl_tpu.data import datasets as jds
from bcfl_tpu.data import partition as jpart
from bcfl_tpu.data.tokenizer import HashTokenizer as JHash
from bcfl_tpu_torch.compression import CompressionConfig, payload_nbytes
from bcfl_tpu_torch.config import FedConfig, PartitionConfig
from bcfl_tpu_torch.data import datasets as tds
from bcfl_tpu_torch.data import partition as tpart
from bcfl_tpu_torch.data.tokenizer import HashTokenizer
from bcfl_tpu_torch.entrypoints import run
from bcfl_tpu_torch.entrypoints.__main__ import main as cli_main
from bcfl_tpu_torch.ops import registry

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; at these tiny shapes torch's
    intra-op threads only oversubscribe the cores (a 3 s run took 30 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(**kw):
    base = dict(dataset="synthetic", model="tiny-bert", num_clients=3,
                num_rounds=2, seq_len=16, batch_size=4, max_local_batches=2,
                vocab_size=512, max_eval_batches=2,
                partition=PartitionConfig(kind="iid", iid_samples=8),
                compression=CompressionConfig(kind="int8+topk"))
    base.update(kw)
    return FedConfig(**base)


def test_cpu_run_end_to_end():
    cfg = _tiny()
    registry.reset_launches()
    res = run(cfg, device="cpu", verbose=False)
    rounds = res.metrics.rounds
    assert [r.round for r in rounds] == [0, 1]
    want = payload_nbytes(cfg.compression, res.trainable) * cfg.num_clients
    for r in rounds:
        assert math.isfinite(r.train_loss) and math.isfinite(r.global_loss)
        assert 0.0 <= r.global_acc <= 1.0 and len(r.local_acc) == 3
        assert r.bytes_on_wire == want and r.bytes_raw > 8 * want
        assert r.wall_s > 0 and not r.degraded
    assert all(bool(torch.isfinite(t).all()) for t in res.trainable.values())
    # the CPU path runs the plain versions: no kernel launch counted
    assert registry.launch_counts() == dict.fromkeys(
        ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd", "int8_quantize",
         "topk_select"), 0)
    assert res.metrics.comms["compression_ratio"] > 8


def test_run_is_deterministic_and_eval_cadence():
    cfg = _tiny(num_rounds=3, eval_every=2,
                compression=CompressionConfig(kind="none"))
    a = run(cfg, device="cpu", verbose=False)
    b = run(cfg, device="cpu", verbose=False)
    for p, x in a.trainable.items():
        assert torch.equal(x, b.trainable[p]), p
    # evaluated at round 2 (every 2nd) and at the last round
    assert [r.global_acc is not None for r in a.metrics.rounds] == [
        False, True, True]
    assert a.metrics.rounds[0].compression_ratio == 1.0


_DIST = dict(runtime="dist", sync="async", eval_every=0, num_clients=4,
             dist=__import__("bcfl_tpu_torch.config", fromlist=["DistConfig"]
                             ).DistConfig(checkpoint_every_versions=0))

NOT_PORTED = [
    # the dist runtime runs, with every fault lane and gossip dispatch;
    # its deferred features (LoRA over dist here) raise at config time
    ("runtime", dict(_DIST, lora_rank=4)),
    ("tp", {"tp": 2}),
    ("sp", {"sp": 2}),
    ("rounds_per_dispatch", {"rounds_per_dispatch": 2}),
    # the flash kernels have no float16 instances yet
    ("compute_dtype", {"compute_dtype": "float16", "use_flash": True}),
]


@pytest.mark.parametrize("field,kw", NOT_PORTED, ids=[f for f, _ in NOT_PORTED])
def test_unsupported_config_raises_not_ported(field, kw):
    with pytest.raises(ValueError, match=f"{field}=.*not ported yet"):
        _tiny(**kw)


PORTED = [
    ("mode", {"mode": "serverless"}),
    ("sync", {"sync": "async", "async_buffer": 2}),
    ("ledger.enabled", {"ledger": __import__(
        "bcfl_tpu_torch.config", fromlist=["LedgerConfig"]).LedgerConfig(
            enabled=True)}),
    ("faithful", {"mode": "serverless", "faithful": True,
                  "compression": CompressionConfig(kind="none")}),
    ("max_grad_norm", {"max_grad_norm": 1.0}),
    ("remat", {"remat": True}),
    ("aggregator", {"aggregator": "trimmed_mean"}),
    ("faults", {"faults": __import__(
        "bcfl_tpu_torch.faults", fromlist=["FaultPlan"]).FaultPlan(
            crash_at_round=1)}),
    ("reputation", {"reputation": __import__(
        "bcfl_tpu_torch.reputation", fromlist=["ReputationConfig"]
    ).ReputationConfig(enabled=True)}),
    ("checkpoint_dir", {"checkpoint_dir": "ck"}),
    # cohort mode, LoRA and the causal-LM task (ported in slice 8)
    ("registry_size", {"registry_size": 8}),
    ("lora_rank", {"lora_rank": 4}),
    ("task", {"task": "causal_lm", "model": "tiny-llama"}),
    # the multi-process runtime's whole-network path (slice 9)
    ("runtime", _DIST),
]


@pytest.mark.parametrize("field,kw", PORTED, ids=[f for f, _ in PORTED])
def test_ported_config_values_construct(field, kw):
    cfg = _tiny(**kw)
    value = cfg
    for part in field.split("."):
        value = getattr(value, part)
    assert value == (kw[field.split(".")[0]] if "." not in field else True)


@pytest.mark.parametrize("buffer", [-1, 0, 3, 4])
def test_async_buffer_checks_match_jax(buffer):
    from bcfl_tpu.config import FedConfig as JCfg

    def outcome(make):
        try:
            make(num_clients=3, sync="async", async_buffer=buffer)
        except ValueError as e:
            return str(e)
        return None

    want = outcome(JCfg)
    got = outcome(FedConfig)
    assert got == want


def test_run_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(_tiny(), verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(_tiny(), device="cuda", verbose=False)


def test_cli_runs_smoke_on_cpu_and_rejects_other_flags(capsys):
    assert cli_main(["--preset", "smoke", "--device", "cpu", "--rounds", "1",
                     "--seq-len", "16", "--max-local-batches", "1",
                     "--compress", "int8+topk"]) == 0
    out = capsys.readouterr().out
    assert "round   0:" in out and "compress=int8+topk" in out
    for flags in (["--rounds-per-dispatch", "2"],
                  ["--no-telemetry"], ["--tp", "2"]):
        with pytest.raises(SystemExit) as e:
            cli_main(["--device", "cpu"] + flags)
        assert e.value.code == 2
    assert "not ported yet" in capsys.readouterr().err


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((ROOT / "bcfl_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for sub in ("topology", "ledger", "parallel", "fed"):
        assert any(f.parent.name == sub for f in files), sub
    banned = ("jax", "jaxlib", "flax", "optax", "bcfl_tpu")
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in banned, f"{f.relative_to(ROOT)} imports {name}"


# ------------------------------------------------- host-side data parity


def test_tokenizer_matches_jax():
    texts = ["Hello, world! It's 42.", "", "  spaces\tand\nnewlines  ",
             "ünïcödé wörds and CAPS", "a " * 40]
    for vocab in (512, 30522):
        for seq in (1, 2, 16):
            ti, tm = HashTokenizer(vocab).encode_batch(texts, seq)
            ji, jm = JHash(vocab).encode_batch(texts, seq)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)


def test_synthetic_and_medical_standin_match_jax(tmp_path):
    for name, kw in (("synthetic", {"num_labels": 3, "n_train": 64,
                                    "n_test": 16}),
                     ("medical_transcriptions",
                      {"data_dir": str(tmp_path / "absent")})):
        t, j = tds.load_dataset(name, **kw), jds.load_dataset(name, **kw)
        assert t.train_texts == j.train_texts and t.test_texts == j.test_texts
        np.testing.assert_array_equal(t.train_labels, j.train_labels)
        assert t.num_labels == j.num_labels and t.name == j.name


def test_csv_loaders_match_jax(tmp_path):
    rows = [("a note, with a comma", "cardio"), ("2nd", "neuro"),
            ("third \"quoted\" text", "cardio"), ("fourth", "derm"),
            ("fifth", "neuro")]
    for split in ("train_file_mt.csv", "test_file_mt.csv", "one.csv"):
        with open(tmp_path / split, "w", newline="") as f:
            import csv

            w = csv.writer(f)
            w.writerow(["description", "medical_specialty", "text", "label"])
            for i, (text, lab) in enumerate(rows):
                w.writerow([text, lab, text, str(i % 3)])
    specs = [("medical_transcriptions", {"data_dir": str(tmp_path)}),
             (f"csv:{tmp_path / 'one.csv'}", {"test_frac": 0.4}),
             (f"csv:{tmp_path / 'one.csv'}::{tmp_path / 'one.csv'}",
              {"label_col": "label"})]
    for name, kw in specs:
        t, j = tds.load_dataset(name, **kw), jds.load_dataset(name, **kw)
        assert t.train_texts == j.train_texts and t.test_texts == j.test_texts
        np.testing.assert_array_equal(t.train_labels, j.train_labels)
        np.testing.assert_array_equal(t.test_labels, j.test_labels)
        assert t.num_labels == j.num_labels


@pytest.mark.parametrize("mode", ["trailing", "fixed"])
def test_contiguous_partitions_match_jax_and_iid_is_seeded(mode):
    import jax

    kw = dict(kind="contiguous", stride=50, train_span=30, test_span=20,
              test_mode=mode)
    tp = tpart.Partitioner(PartitionConfig(**kw), 120, 90, seed=0)
    jp = jpart.Partitioner(JPart(**kw), 120, 90, jax.random.key(0))
    for client in range(5):  # clients 3-4 wrap past the end
        for a, b in zip(tp.train_test_indices(client, 0),
                        jp.train_test_indices(client, 0)):
            np.testing.assert_array_equal(a, b)
    iid = tpart.Partitioner(PartitionConfig(kind="iid", iid_samples=10),
                            100, 40, seed=3)
    tr, te = iid.train_test_indices(1, 0)
    assert len(set(tr.tolist())) == 10 and len(te) == 10
    np.testing.assert_array_equal(tr, iid.train_test_indices(1, 5)[0])
    assert not np.array_equal(tr, iid.train_test_indices(2, 0)[0])


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_records_only_what_it_measured(monkeypatch, capsys):
    smoke = _chip_smoke()
    for op in registry.kernel_ops():
        rec = smoke.KernelStats(op).record()
        assert rec["source"] == f"bcfl_tpu_torch/csrc/{op.source}.cu"
        assert (ROOT / rec["source"]).is_file()
        assert rec["replaces"].split(":")[0] in (
            "bcfl_tpu/ops/pallas_codec.py", "bcfl_tpu/ops/pallas_flash.py")
        # nothing measured yet: every measured field is null, never 0
        for key in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms"):
            assert rec[key] is None, key
    # no card: a non-zero exit and no result on stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main([]) != 0
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        smoke.main(["--phases", "build"])  # no subset knob


def test_chip_smoke_pins_the_jax_pagerank_anomalies():
    from bcfl_tpu.topology import anomaly_filter, reference_graph

    want = anomaly_filter("pagerank", reference_graph(), protect=(1,))
    assert _chip_smoke().PAGERANK_ANOMALIES == want["anomalies"]


def test_resolve_device_leaves_float32_policy_alone(monkeypatch):
    from bcfl_tpu_torch.core import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device().type == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_chip_smoke_reads_the_ptxas_report():
    smoke = _chip_smoke()
    entry = ("ptxas info    : Compiling entry function '_ZN5flash49_GLOBAL__N"
             "__3402fc56_16_flash_bwd_dkv_cu_584b2df1{}' for 'sm_90a'")
    log = "\n".join([
        entry.format("19flash_bwd_dkv_wgmmaILi64EEEvNS_6ParamsI13__nv_bfloat"
                     "16EE"),
        "ptxas info    : Function properties for x",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
        entry.format("20flash_bwd_dkv_kernelIfLi128EEEvNS_6ParamsIT_EE"),
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to insufficient register resources",
        "ptxas info    : Compiling entry function '_Z13int8_kernelPKf' for "
        "'sm_90a'",
        "ptxas info    : Used 30 registers, used 1 barriers",
    ])
    notes = smoke.ptxas_notes({"flash_bwd_dkv": log, "int8_quantize": ""})
    assert notes == [
        "ptxas flash_bwd_dkv_wgmma<bf16, 64>: 255 registers, 8 bytes spilled",
        "ptxas flash_bwd_dkv_kernel<f32, 128>: 168 registers, 0 bytes "
        "spilled",
        "ptxas WARNING (flash_bwd_dkv): ptxas info    : (C7512) Potential "
        "Performance Loss: wgmma.mma_async instructions are serialized due "
        "to insufficient register resources"]
