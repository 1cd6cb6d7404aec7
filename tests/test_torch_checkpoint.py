"""PyTorch port (``bcfl_tpu_torch``): crash-safe checkpoints and
crash/resume, inside the port (a JAX checkpoint is orbax, which the port
does not read, so the contract here is the port's own).

- The checkpoint format: the JAX package's checkpoint tests
  (``tests/test_faults.py``) run against the port's ``torch.save`` format:
  a truncated newest checkpoint falls back to the previous one, so does a
  digest mismatch, all-invalid returns None, an interrupted save is
  invisible; ``classify_round`` names each damage status, ``scrub`` audits
  a directory, ``keep_last`` keeps the newest rounds only after a commit.
- Crash/resume: a run that crashes (the fault plan's ``crash_at_round``)
  and resumes from its newest checkpoint equals the uninterrupted run bit
  for bit, for server FedAvg, serverless gossip with its stacked state,
  compressed rounds with the error-feedback residual and the ledger, and
  the composition case of ``tests/test_reputation.py`` (partition + churn
  + flaky + trimmed_mean + int8+topk + ledger + reputation). The crash
  still fires under ``resume=True`` when there is nothing to restore; a
  changed seed, codec or PRNG scheme refuses to resume; an engine whose
  newest checkpoint is truncated resumes from the one before.
- The entry points: the CLI's ``--chaos-crash-round`` then ``--resume``,
  and ``run_sweep(..., resume=True)`` over per-count subdirectories.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from bcfl_tpu_torch.checkpoint import (ROUND_STATUSES, classify_round,
                                       restore_checkpoint, restore_latest,
                                       save_checkpoint, scrub)
from bcfl_tpu_torch.compression import CompressionConfig
from bcfl_tpu_torch.config import FedConfig, LedgerConfig, PartitionConfig
from bcfl_tpu_torch.entrypoints import run_sweep
from bcfl_tpu_torch.entrypoints.__main__ import main as cli_main
from bcfl_tpu_torch.faults import FaultPlan, SimulatedCrash
from bcfl_tpu_torch.fed.engine import FedEngine
from bcfl_tpu_torch.ledger import Ledger
from bcfl_tpu_torch.reputation import ReputationConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(**kw):
    base = dict(dataset="synthetic", model="tiny-bert", num_clients=3,
                num_rounds=3, seq_len=16, batch_size=4, max_local_batches=1,
                vocab_size=512, max_eval_batches=1, eval_every=0,
                partition=PartitionConfig(kind="iid", iid_samples=8))
    base.update(kw)
    return FedConfig(**base)


# ------------------------------------------------------ the format alone


def _state(v: float):
    return {"trainable": {"w": np.full((8, 4), v, np.float32)},
            "seed": np.int64(42)}


def _wipe(path):
    for f in glob.glob(os.path.join(path, "**"), recursive=True):
        if os.path.isfile(f):
            os.remove(f)


def test_truncated_newest_checkpoint_falls_back(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, _state(0.0), ledger_json="[]")
    p1 = save_checkpoint(d, 1, _state(1.0))
    _wipe(p1)
    r, state, ledger_json = restore_latest(d)
    assert r == 0 and ledger_json == "[]"
    assert torch.equal(state["trainable"]["w"], torch.zeros(8, 4))
    assert int(state["seed"]) == 42 and state["seed"].dtype == torch.int64
    # a torn file (its tail cut) is unrestorable too
    p2 = save_checkpoint(d, 2, _state(2.0))
    f = os.path.join(p2, "state.pt")
    with open(f, "r+b") as fh:
        fh.truncate(os.path.getsize(f) // 2)
    assert classify_round(d, 2)[0] == "unrestorable"
    assert restore_latest(d)[0] == 0


def test_corrupted_newest_checkpoint_digest_falls_back(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, _state(0.0))
    p1 = save_checkpoint(d, 1, _state(1.0))
    # flip bytes of the stored tensor itself: either the loader or the
    # committed digest must reject it
    f = os.path.join(p1, "state.pt")
    blob = open(f, "rb").read()
    at = blob.index(np.full(4, 1.0, np.float32).tobytes())
    with open(f, "r+b") as fh:
        fh.seek(at)
        fh.write(b"\xde\xad\xbe\xef" * 4)
    assert classify_round(d, 1)[0] in ("unrestorable", "digest_mismatch")
    r, _, _ = restore_latest(d)
    assert r == 0


def test_digest_mismatch_of_a_loadable_state(tmp_path):
    """A state that still loads but is not the one the meta committed."""
    d = str(tmp_path)
    save_checkpoint(d, 0, _state(0.0))
    save_checkpoint(d, 1, _state(1.0))
    torch.save({"trainable": {"w": torch.full((8, 4), 5.0)},
                "seed": torch.tensor(42)},
               os.path.join(d, "round_000001", "state.pt"))
    assert classify_round(d, 1)[0] == "digest_mismatch"
    assert restore_latest(d)[0] == 0
    assert restore_checkpoint(d, 1) is None
    r, state, _ = restore_checkpoint(d, 0)
    assert r == 0 and float(state["trainable"]["w"][0, 0]) == 0.0


def test_all_checkpoints_invalid_returns_none(tmp_path):
    d = str(tmp_path)
    _wipe(save_checkpoint(d, 0, _state(0.0)))
    assert restore_latest(d) is None
    assert restore_latest(str(tmp_path / "absent")) is None


def test_interrupted_save_is_invisible(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, _state(0.0))
    os.makedirs(os.path.join(d, ".staging.round_000001"))
    r, _, _ = restore_latest(d)
    assert r == 0
    assert scrub(d)["torn"] == (".staging.round_000001",)
    # the next save of that round clears the leftover and commits
    save_checkpoint(d, 1, _state(1.0))
    r, state, _ = restore_latest(d)
    assert r == 1 and float(state["trainable"]["w"][0, 0]) == 1.0
    assert scrub(d)["torn"] == ()


def test_classify_round_statuses_and_scrub(tmp_path):
    d = str(tmp_path)
    led = Ledger()
    led.append_digest(0, 0, b"\x01" * 32, 10)
    good = led.to_json()
    for r in range(7):
        save_checkpoint(d, r, _state(float(r)), ledger_json=good)
    meta = lambda r: os.path.join(d, f"round_{r:06d}.meta.json")  # noqa
    rdir = lambda r: os.path.join(d, f"round_{r:06d}")  # noqa
    os.remove(meta(1))                                  # unverified
    _wipe(rdir(2))                                      # unrestorable
    torch.save({"trainable": {"w": torch.ones(8, 4)}},
               os.path.join(rdir(3), "state.pt"))       # digest_mismatch
    with open(meta(4), "w") as f:
        f.write("{not json")                            # meta_corrupt
    import json
    bad = json.loads(good)
    bad[0]["payload_bytes"] = 11
    m5 = json.load(open(meta(5)))
    m5["ledger"] = json.dumps(bad)
    with open(meta(5), "w") as f:
        json.dump(m5, f)                                # ledger_corrupt
    import shutil
    shutil.rmtree(rdir(6))                              # deleted
    want = {0: "ok", 1: "unverified", 2: "unrestorable",
            3: "digest_mismatch", 4: "meta_corrupt", 5: "ledger_corrupt",
            6: "deleted", 7: "missing"}
    for r, status in want.items():
        assert classify_round(d, r)[0] == status, r
    assert set(want.values()) == set(ROUND_STATUSES)
    rep = scrub(d)
    assert rep["rounds"] == tuple((r, s) for r, s in want.items() if r < 7)
    assert rep["newest_intact"] == 1 and not rep["empty"]
    assert rep["damaged"] == tuple((r, s) for r, s in want.items()
                                   if 2 <= r <= 6)
    assert restore_latest(d)[0] == 1
    assert scrub(str(tmp_path / "none"))["empty"]


def test_keep_last_removes_only_after_commit(tmp_path):
    d = str(tmp_path)
    for r in range(5):
        save_checkpoint(d, r, _state(float(r)), keep_last=2)
    assert sorted(os.listdir(d)) == [
        "round_000003", "round_000003.meta.json",
        "round_000004", "round_000004.meta.json"]
    # a re-save of a round keeps the others and verifies
    save_checkpoint(d, 4, _state(9.0), keep_last=2)
    assert classify_round(d, 4)[0] == "ok"
    assert float(restore_latest(d)[1]["trainable"]["w"][0, 0]) == 9.0


def test_state_tree_round_trips_with_dtypes(tmp_path):
    state = {"trainable": {"a/kernel": torch.randn(3, 2).bfloat16(),
                           "b": torch.arange(4, dtype=torch.int32)},
             "stacked": None,
             "text": np.frombuffer(b"int8+topk", np.uint8).copy(),
             "rep_trust": np.array([1.0, 0.4])}
    save_checkpoint(str(tmp_path), 0, state)
    status, got, _ = classify_round(str(tmp_path), 0)
    assert status == "ok" and "stacked" not in got
    assert torch.equal(got["trainable"]["a/kernel"],
                       state["trainable"]["a/kernel"])
    assert got["trainable"]["b"].dtype == torch.int32
    assert bytes(got["text"].numpy()) == b"int8+topk"
    assert got["rep_trust"].dtype == torch.float64


# ------------------------------------------------------- crash and resume


def _assert_same_run(a, b, first):
    """``b`` (resumed at round ``first``) equals ``a`` (uninterrupted)."""
    assert [r.round for r in b.metrics.rounds] == list(
        range(first, len(a.metrics.rounds)))
    for p in a.trainable:
        assert torch.equal(a.trainable[p], b.trainable[p]), p
    for ra, rb in zip(a.metrics.rounds[first:], b.metrics.rounds):
        for f in ("train_loss", "train_acc", "local_acc", "mask", "auth",
                  "partition", "healed", "churn_alive", "dropped",
                  "reputation_state", "reputation_trust", "global_acc"):
            assert getattr(ra, f) == getattr(rb, f), (ra.round, f)
    if a.ledger is not None:
        assert a.ledger.head == b.ledger.head
        assert a.ledger.to_json() == b.ledger.to_json()
    assert a.metrics.reputation == b.metrics.reputation


def _crash_resume(tmp_path, cfg, crash_at):
    ref = FedEngine(cfg, device="cpu").run()
    crash = cfg.replace(
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
        faults=dataclasses.replace(cfg.faults or FaultPlan(),
                                   crash_at_round=crash_at))
    with pytest.raises(SimulatedCrash) as e:
        FedEngine(crash, device="cpu").run()
    assert e.value.round == crash_at
    eng = FedEngine(crash, device="cpu")
    res = eng.run(resume=True)
    return ref, res, eng


@pytest.mark.parametrize("kw", [
    dict(mode="server"),
    dict(mode="serverless", eval_every=1),
    dict(mode="server", aggregator="median",
         compression=CompressionConfig(kind="int8+topk"),
         ledger=LedgerConfig(enabled=True)),
    dict(mode="serverless", compression=CompressionConfig(kind="int8"),
         ledger=LedgerConfig(enabled=True),
         faults=FaultPlan(corrupt_prob=0.5, dropout_prob=0.3)),
], ids=["server", "serverless-stacked", "server-codec-ef-ledger",
        "serverless-codec-corrupt-ledger"])
def test_crash_resume_bit_identical(tmp_path, kw):
    ref, res, eng = _crash_resume(tmp_path, _tiny(**kw), crash_at=2)
    _assert_same_run(ref, res, 2)
    if eng._comp is not None:
        assert eng._ef is not None
    phases = res.metrics.phases
    assert phases["restore"]["count"] == 1 and "checkpoint" in phases


def test_composition_crash_resume_bit_identical(tmp_path):
    """``tests/test_reputation.py``'s chaos-matrix case in the port:
    partition + churn + flaky with trimmed_mean, int8+topk and the ledger,
    reputation on; the crash at round 3 resumes from round 2's checkpoint
    (after the partition's heal window opened)."""
    base = _tiny(
        num_clients=4, num_rounds=5, aggregator="trimmed_mean",
        compression=CompressionConfig(kind="int8+topk"),
        ledger=LedgerConfig(enabled=True),
        reputation=ReputationConfig(enabled=True, quarantine_rounds=2),
        faults=FaultPlan(
            seed=11, partition_groups=((0, 1), (2, 3)),
            partition_rounds=(1, 2), churn_leave=((2, 4),),
            churn_join=((3, 1),), flaky_clients=(1,), flaky_burst_len=2,
            flaky_on_prob=1.0))
    ref, res, _ = _crash_resume(tmp_path, base, crash_at=3)
    recs = ref.metrics.rounds
    assert any(r.partition for r in recs)
    assert any(r.auth and 0.0 in r.auth for r in recs)
    assert recs[3].healed and not any(r.healed for r in recs[:3])
    assert ref.metrics.reputation["total_quarantine_events"] >= 1
    _assert_same_run(ref, res, 3)


def test_resume_mid_partition_from_stacked_view(tmp_path):
    """A checkpoint inside the span holds the per-component stacked view;
    the resumed run reruns the span's last round and heals on time."""
    base = _tiny(num_clients=4, num_rounds=4,
                 faults=FaultPlan(partition_count=2, partition_rounds=(1, 2)),
                 checkpoint_every=2)
    ref = FedEngine(base, device="cpu").run()
    crash = base.replace(checkpoint_dir=str(tmp_path), faults=dataclasses.
                         replace(base.faults, crash_at_round=3))
    with pytest.raises(SimulatedCrash):
        FedEngine(crash, device="cpu").run()
    r, state, _ = restore_latest(str(tmp_path))
    assert r == 1 and state["stacked"]["classifier/kernel"].shape[0] == 4
    res = FedEngine(crash, device="cpu").run(resume=True)
    assert res.metrics.rounds[1].healed
    _assert_same_run(ref, res, 2)


def test_crash_fires_despite_resume_flag_without_checkpoint(tmp_path):
    cfg = _tiny(num_rounds=2, checkpoint_dir=str(tmp_path / "fresh"),
                checkpoint_every=1, faults=FaultPlan(crash_at_round=0))
    with pytest.raises(SimulatedCrash):
        FedEngine(cfg, device="cpu").run(resume=True)


def test_resume_guards_refuse_a_changed_run(tmp_path):
    cfg = _tiny(num_rounds=1, checkpoint_dir=str(tmp_path),
                checkpoint_every=1,
                compression=CompressionConfig(kind="int8+topk"))
    FedEngine(cfg, device="cpu").run()
    cfg2 = cfg.replace(num_rounds=2)
    with pytest.raises(ValueError, match="seed 42 but config has seed 7"):
        FedEngine(cfg2.replace(seed=7), device="cpu").run(resume=True)
    with pytest.raises(ValueError, match="compress=.*int8\\+topk.*'int8:"):
        FedEngine(cfg2.replace(compression=CompressionConfig(kind="int8")),
                  device="cpu").run(resume=True)
    eng = FedEngine(cfg2, device="cpu")
    eng._prng_name = "blake2b-coords-v1:torch.Generator[cuda]"
    with pytest.raises(ValueError, match="PRNG scheme"):
        eng.run(resume=True)
    # the unchanged run resumes
    assert [r.round for r in FedEngine(cfg2, device="cpu").run(
        resume=True).metrics.rounds] == [1]


def test_resume_casts_floats_to_the_configured_param_dtype(tmp_path):
    cfg = _tiny(num_rounds=1, checkpoint_dir=str(tmp_path),
                checkpoint_every=1)
    FedEngine(cfg, device="cpu").run()
    res = FedEngine(cfg.replace(num_rounds=2, param_dtype="bfloat16",
                                optimizer="sgd"),
                    device="cpu").run(resume=True)
    assert all(x.dtype == torch.bfloat16 for x in res.trainable.values())


def test_engine_resumes_from_valid_after_truncation(tmp_path):
    cfg = _tiny(num_rounds=2, checkpoint_dir=str(tmp_path),
                checkpoint_every=1)
    FedEngine(cfg, device="cpu").run()
    _wipe(os.path.join(str(tmp_path), "round_000001"))
    res = FedEngine(cfg.replace(num_rounds=3), device="cpu").run(resume=True)
    assert [r.round for r in res.metrics.rounds] == [1, 2]


# ---------------------------------------------------------- entry points


def test_cli_crash_then_resume(tmp_path, capsys):
    args = ["--preset", "smoke", "--device", "cpu", "--rounds", "3",
            "--seq-len", "16", "--max-local-batches", "1",
            "--chaos-crash-round", "1", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "1"]
    with pytest.raises(SimulatedCrash):
        cli_main(args)
    assert cli_main(args + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "round   1:" in out and "round   2:" in out
    assert "round   0:" not in out.split("--resume")[-1].split(
        "== smoke ==")[-1]
    assert sorted(d for d in os.listdir(tmp_path) if "meta" not in d) == [
        "round_000000", "round_000001", "round_000002"]


def test_cli_parses_chaos_and_reputation_flags_as_jax():
    from bcfl_tpu_torch.entrypoints.__main__ import build_config, build_parser

    args = build_parser().parse_args([
        "--aggregator", "krum", "--aggregator-trim", "0.3",
        "--chaos-dropout", "0.2", "--chaos-straggler", "0.5",
        "--chaos-straggler-delay", "4", "--chaos-corrupt", "0.1",
        "--chaos-partition", "0,1/2", "--chaos-partition-rounds", "2:5",
        "--chaos-churn-leave", "1:3", "--chaos-churn-join", "2:1",
        "--chaos-churn-join", "0:2", "--chaos-flaky", "0,2",
        "--chaos-flaky-burst", "4", "--chaos-flaky-on-prob", "0.9",
        "--chaos-seed", "5", "--reputation", "--reputation-alpha", "0.5",
        "--reputation-quarantine-rounds", "4", "--checkpoint-dir", "ck",
        "--checkpoint-every", "2", "--clients", "4", "--mode", "server"])
    cfg = build_config(args)
    assert cfg.aggregator == "krum" and cfg.aggregator_trim == 0.3
    assert cfg.faults == FaultPlan(
        seed=5, dropout_prob=0.2, straggler_prob=0.5, straggler_delay_s=4.0,
        corrupt_prob=0.1, partition_groups=((0, 1), (2,)),
        partition_rounds=(2, 3, 4), churn_leave=((1, 3),),
        churn_join=((2, 1), (0, 2)), flaky_clients=(0, 2), flaky_burst_len=4,
        flaky_on_prob=0.9)
    assert cfg.reputation == ReputationConfig(enabled=True, ewma_alpha=0.5,
                                              quarantine_rounds=4)
    assert (cfg.checkpoint_dir, cfg.checkpoint_every) == ("ck", 2)
    count = build_config(build_parser().parse_args(
        ["--chaos-partition", "3", "--chaos-partition-rounds", "0:1",
         "--mode", "server"]))
    assert count.faults.partition_count == 3
    for bad, msg in ((["--chaos-partition", "2"], "needs"),
                     (["--chaos-partition", "2", "--chaos-partition-rounds",
                       "3:3"], "empty span"),
                     (["--chaos-churn-leave", "1-3"], "CLIENT:ROUND"),
                     (["--reputation-alpha", "0.5"], "without --reputation")):
        with pytest.raises(SystemExit, match=msg):
            build_config(build_parser().parse_args(bad))


def test_run_sweep_resumes_each_count_from_its_subdirectory(tmp_path):
    cfg = _tiny(name="sw", num_rounds=1, mode="serverless",
                checkpoint_dir=str(tmp_path), checkpoint_every=1)
    first = run_sweep(cfg, [2, 3], device="cpu", verbose=False,
                      out_dir=None)
    assert sorted(os.listdir(tmp_path)) == ["c2", "c3"]
    again = run_sweep(cfg.replace(num_rounds=2), [2, 3], device="cpu",
                      verbose=False, out_dir=None, resume=True)
    for n in (2, 3):
        assert [r.round for r in again[n].metrics.rounds] == [1]
        assert len(again[n].metrics.rounds[0].local_acc) == n
        assert first[n].metrics.rounds[0].round == 0


def test_type_embedding_one_hot_lookup_equals_the_rows():
    """The token-type rows are looked up as a one-hot product (a matmul
    gradient, deterministic on the card, where CUDA's embedding backward
    over thousands of repeats of one row is not): the forward gives the
    embedding rows exactly, and the gradient equals the lookup's."""
    import torch.nn.functional as F

    from bcfl_tpu_torch.models import build

    model = build("tiny-bert", num_labels=2, vocab_size=512,
                  dtype=torch.float32)
    emb = model.encoder.embeddings
    types = emb._modules["type"]
    with torch.no_grad():
        types.weight.normal_()
    ids = torch.randint(0, 512, (3, 16))
    type_ids = torch.randint(0, types.num_embeddings, (3, 16))
    got = emb(ids, type_ids, True, None)
    pos = torch.arange(16)[None, :]
    want = (emb.word(ids) + emb.position(pos) + types(type_ids))
    want = F.layer_norm(want, emb.norm.normalized_shape, emb.norm.weight,
                        emb.norm.bias, emb.norm.eps)
    assert torch.equal(got, want)
    g = torch.randn_like(got)
    (gw,) = torch.autograd.grad((emb(ids, type_ids, True, None) * g).sum(),
                                types.weight)
    (ref,) = torch.autograd.grad((want * g).sum(), types.weight)
    torch.testing.assert_close(gw, ref, rtol=1e-5, atol=1e-6)
