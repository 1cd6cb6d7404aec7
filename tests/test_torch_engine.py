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
    # the dist runtime runs, with every fault lane, gossip dispatch, LoRA
    # and Llama; a feature deferred on it (local_epochs here: tp and sp
    # are refused earlier on dist, by the runtime's capability table)
    # raises at config time, naming the runtime
    ("runtime", dict(_DIST, local_epochs=2)),
    ("local_epochs", {"local_epochs": 2}),
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
    # float16 compute with flash: the kernels' fp16 instances, on the
    # local and the dist runtime
    ("compute_dtype", {"compute_dtype": "float16", "use_flash": True}),
    ("compute_dtype", dict(_DIST, compute_dtype="float16", use_flash=True)),
    # tensor and sequence parallelism (slice 15), as JAX's configs
    # construct them: tp over a LoRA base, sp with a divisible seq_len
    ("tp", {"tp": 2, "lora_rank": 2}),
    ("sp", {"sp": 2}),
    # the fused multi-round dispatch
    ("rounds_per_dispatch", {"rounds_per_dispatch": 2}),
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


@pytest.mark.parametrize("model,layers", [("tiny-bert", 1),
                                          ("tiny-llama", 1),
                                          ("tiny-bert", 0)])
def test_num_layers_cuts_depth_at_the_model_width(model, layers):
    """``num_layers`` builds that many layers at the model's own width (0:
    the catalog depth), and the peer processes' JSON carries it."""
    from bcfl_tpu_torch.dist.launch import cfg_from_json, cfg_to_json
    from bcfl_tpu_torch.fed.engine import FedEngine
    from bcfl_tpu_torch.models import build, get_config
    from bcfl_tpu_torch.models.convert import trainable_tree

    cfg = _tiny(model=model, num_layers=layers)
    assert cfg_from_json(cfg_to_json(cfg)) == cfg
    eng = FedEngine(cfg, device="cpu")
    full = get_config(model)
    assert eng.model.cfg.num_layers == (layers or full.num_layers)
    assert eng.model.cfg.hidden_size == full.hidden_size
    names = {p.split("/")[1] for p in eng.trainable0
             if p.split("/")[1].startswith("layer_")}
    assert len(names) == (layers or full.num_layers)
    want = trainable_tree(build(model, num_labels=eng.num_labels,
                                vocab_size=512,
                                num_layers=layers or full.num_layers))
    assert ({p: tuple(x.shape) for p, x in eng.trainable0.items()}
            == {p: tuple(x.shape) for p, x in want.items()})


@pytest.mark.parametrize("kw,match", [
    ({"num_layers": -1}, "num_layers must be >= 0"),
    ({"num_layers": 2, "hf_checkpoint": "ckpt"}, "brings its own"),
])
def test_num_layers_refuses_what_it_cannot_cut(kw, match):
    with pytest.raises(ValueError, match=match):
        _tiny(**kw)


def test_run_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(_tiny(), verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(_tiny(), device="cuda", verbose=False)


def test_cli_runs_fp16_flash_on_cpu(capsys, monkeypatch):
    """``--compute-dtype float16 --use-flash on`` trains one tiny round
    on the CPU through the flash ops' plain versions at float16."""
    from bcfl_tpu_torch.ops import flash_kernels as fk

    seen = []
    for op in (fk.FLASH_FWD, fk.FLASH_BWD_DKV, fk.FLASH_BWD_DQ):
        def spy(q, *args, _plain=op.torch, _name=op.name, **kw):
            seen.append((_name, q.dtype))
            return _plain(q, *args, **kw)
        monkeypatch.setattr(op, "torch", spy)
    registry.reset_launches()
    assert cli_main(["--preset", "smoke", "--device", "cpu", "--rounds", "1",
                     "--mode", "server", "--model", "tiny-bert",
                     "--seq-len", "32", "--max-local-batches", "1",
                     "--compute-dtype", "float16", "--use-flash", "on"]) == 0
    assert "round   0:" in capsys.readouterr().out
    assert set(seen) == {(name, torch.float16) for name in
                         ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    assert set(registry.launch_counts().values()) == {0}  # no kernel here


def test_cli_runs_smoke_on_cpu_and_rejects_other_flags(capsys):
    assert cli_main(["--preset", "smoke", "--device", "cpu", "--rounds", "1",
                     "--seq-len", "16", "--max-local-batches", "1",
                     "--compress", "int8+topk"]) == 0
    out = capsys.readouterr().out
    assert "round   0:" in out and "compress=int8+topk" in out
    with pytest.raises(SystemExit) as e:
        cli_main(["--device", "cpu", "--donate"])
    assert e.value.code == 2
    assert "not ported yet" in capsys.readouterr().err
    # --rounds-per-dispatch is ported: JAX's flag, mapped to its field
    from bcfl_tpu_torch.entrypoints.__main__ import build_config, build_parser

    args = build_parser().parse_args(["--rounds-per-dispatch", "4"])
    assert build_config(args).rounds_per_dispatch == 4
    # --tp is ported: the command line takes the engine's devices, which
    # refuse an inner axis larger than a one-device CPU list in JAX's words
    # (the command line itself runs --tp on as many CPU devices as it needs:
    # tests/test_torch_fed_tp.py)
    from bcfl_tpu_torch.fed.engine import FedEngine

    with pytest.raises(ValueError, match="tp=2 needs at least that many "
                                         "devices, have 1"):
        FedEngine(_tiny(tp=2, lora_rank=2), devices=["cpu"])


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
        entry.format("19flash_bwd_dkv_wgmmaI6__halfLi128EEEvNS_6ParamsIT_EE"),
        "    0 bytes stack frame, 96 bytes spill stores, 96 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
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
        "ptxas flash_bwd_dkv_wgmma<fp16, 128>: 255 registers, 96 bytes "
        "spilled",
        "ptxas WARNING (flash_bwd_dkv): ptxas info    : (C7512) Potential "
        "Performance Loss: wgmma.mma_async instructions are serialized due "
        "to insufficient register resources"]


def test_chip_smoke_tells_flash_instances_apart():
    """The route check reads the instance (route, element type) from the
    profiler's demangled kernel name, per op."""
    smoke = _chip_smoke()
    name = ("void flash::(anonymous namespace)::flash_bwd_dq_wgmma<__half, "
            "64>(flash::Params<__half>)")
    assert smoke.flash_instance(name, "flash_bwd_dq") == ("wgmma", "__half")
    assert smoke.flash_instance(name, "flash_bwd_dkv") is None
    assert smoke.flash_instance(name.replace("__half", "__nv_bfloat16"),
                                "flash_bwd_dq") == ("wgmma", "__nv_bfloat16")
    assert smoke.flash_instance(
        "void flash::(anonymous namespace)::flash_fwd_kernel<float, 32>("
        "flash::Params<float>)", "flash_fwd") == ("kernel", "float")
    assert set(smoke.FLASH_INSTANCES) == {torch.bfloat16, torch.float16,
                                          torch.float32}
    assert len(set(smoke.FLASH_INSTANCES.values())) == 3
