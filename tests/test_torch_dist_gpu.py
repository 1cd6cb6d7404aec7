"""PyTorch port (``bcfl_tpu_torch``): the multi-process runtime on the card.

Two peer processes (tiny-bert, ``int8+topk``, the ledger) run on the one
GPU over loopback TCP: both end ok at the target version, the int8 and
top-k codec kernels (K4, K5) launched in both peers' CUDA contexts, every
chain verifies and the heads agree, every merged arrival authenticated
(the leader refingerprints the arrived bytes on its own context and
matches the sender's announcement bit for bit), and the collated timeline
holds every invariant.

A second run splits the two peers by a partition and SIGKILLs peer 1
after its first checkpoint: the chain forks and heals through the
verified reconcile, peer 1 resumes in a fresh CUDA context from the
checkpoint (its restored trainable and residual equal to the file bit for
bit), and K4/K5 launch in both of its incarnations.

A third runs the byzantine lane: 3 peers under ``trimmed_mean`` with
per-peer reputation, peer 2 scaling and forging its ``int8+topk``
updates; the leader quarantines it (through the robust merge's outlier
flags, weighed 1.0: the fingerprint cannot see a forged scale of the
codec), is SIGKILLed after its version-4 checkpoint and resumes in a
fresh CUDA context with its tracker bit for bit the file's, never
readmits peer 2, and launches K4/K5 there.

A fourth holds the gossip merge on the card: ``merge_states`` over three
biobert-base-wide float32 states on the GPU equals the CPU's bit for bit
(one multiply and one add per input, no fused multiply-add). A fifth runs
the wire, limp and resource lanes over two card peers' ``int8+topk``
frames: every frame the lanes drop, duplicate, hold or corrupt still
merges once, the chains agree, and K4/K5 launch in both peers. A sixth
runs three gossip peers on the card through a partition and its
leaderless heal.

The tests are marked ``gpu`` and skip without a card. This file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_dist_gpu.py
"""

import pytest
import torch


@pytest.mark.gpu
def test_two_peers_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the peers run K4/K5 on the card)")
    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.config import (DistConfig, FedConfig, LedgerConfig,
                                       PartitionConfig)
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.ops import cuda_build
    from bcfl_tpu_torch.telemetry import collate_run

    cuda_build.build_all()  # once, before the peers start
    cfg = FedConfig(
        name="dist_gpu", runtime="dist", mode="server", sync="async",
        model="tiny-bert", dataset="synthetic", num_clients=4, num_rounds=3,
        seq_len=32, batch_size=8, max_local_batches=2, eval_every=0,
        partition=PartitionConfig(kind="iid", iid_samples=16),
        ledger=LedgerConfig(enabled=True),
        compression=CompressionConfig(kind="int8+topk"),
        dist=DistConfig(peers=2, peer_deadline_s=150.0,
                        checkpoint_every_versions=0))
    result = run_dist(cfg, str(tmp_path / "run"), deadline_s=180.0,
                      device="cuda")
    assert result["ok"], result["log_tails"]
    reports = result["reports"]
    for p in (0, 1):
        r = reports[p]
        assert r["final_version"] >= cfg.num_rounds
        assert r["chain_ok"]
        assert r["device"].startswith("cuda")
        assert r["kernel_launches"]["int8_quantize"] > 0
        assert r["kernel_launches"]["topk_select"] > 0
        assert r["peak_gb"] > 0
    assert reports[0]["chain_head"] == reports[1]["chain_head"]
    arrivals = [a for m in reports[0]["merges"] for a in m["arrivals"]]
    assert arrivals and all(a["auth"] == [1.0, 1.0] for a in arrivals)
    col = collate_run(result["run_dir"])
    assert col["ok"], col["violations"]


@pytest.mark.gpu
def test_partition_and_kill_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the peers run K4/K5 on the card)")
    import os

    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.config import (DistConfig, FedConfig, LedgerConfig,
                                       PartitionConfig)
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.faults import FaultPlan
    from bcfl_tpu_torch.ledger.ledger import params_digest
    from bcfl_tpu_torch.ops import cuda_build
    from bcfl_tpu_torch.telemetry import collate_run

    cuda_build.build_all()
    cfg = FedConfig(
        name="dist_gpu_partition", runtime="dist", mode="server",
        sync="async", model="tiny-bert", dataset="synthetic", num_clients=4,
        num_rounds=8, seq_len=32, batch_size=8, max_local_batches=2,
        eval_every=0, partition=PartitionConfig(kind="iid", iid_samples=16),
        ledger=LedgerConfig(enabled=True),
        compression=CompressionConfig(kind="int8+topk"),
        faults=FaultPlan(partition_groups=((0,), (1,)),
                         partition_rounds=(2, 3)),
        dist=DistConfig(peers=2, buffer=2, buffer_timeout_s=10.0,
                        peer_deadline_s=200.0, checkpoint_every_versions=1))
    result = run_dist(cfg, str(tmp_path / "run"), deadline_s=230.0,
                      device="cuda", kill_peer=1)
    assert result["ok"], result["log_tails"]
    reports = result["reports"]
    rec = reports[0]["reconcile"]
    assert rec["forked"] and rec["chain_ok"]
    assert reports[0]["chain_head"] == reports[1]["chain_head"]
    # solo merges count per incarnation: peer 1's may lie in either
    both = [reports[1]] + result["incarnation_reports"][1]
    assert reports[0]["solo_merges"] > 0
    assert sum(r["solo_merges"] for r in both) > 0
    assert reports[1]["resumed"] and reports[1]["incarnation"] == 2
    for r in both:
        assert r["kernel_launches"]["int8_quantize"] > 0
        assert r["kernel_launches"]["topk_select"] > 0
    kill = result["kill"]
    state = torch.load(os.path.join(kill["kept"], f"round_{kill['round']:06d}",
                                    "state.pt"), weights_only=True)
    restored = reports[1]["restored"]
    assert restored["version"] == kill["round"]
    for key in ("trainable", "ef_residual"):
        assert restored[f"{key}_digest"] == params_digest(
            state[key], use_native=False).hex()
    col = collate_run(result["run_dir"])
    assert col["ok"], col["violations"]


@pytest.mark.gpu
def test_byzantine_leader_killed_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the peers run K4/K5 on the card)")
    import os

    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.config import (DistConfig, FedConfig, LedgerConfig,
                                       PartitionConfig)
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.faults import FaultPlan
    from bcfl_tpu_torch.ops import cuda_build
    from bcfl_tpu_torch.reputation import ReputationConfig
    from bcfl_tpu_torch.telemetry import collate_run

    cuda_build.build_all()
    cfg = FedConfig(
        name="dist_gpu_byz", runtime="dist", mode="server", sync="async",
        model="tiny-bert", dataset="synthetic", num_clients=6, num_rounds=8,
        seq_len=32, batch_size=8, max_local_batches=2, eval_every=0,
        partition=PartitionConfig(kind="iid", iid_samples=16),
        ledger=LedgerConfig(enabled=True), aggregator="trimmed_mean",
        compression=CompressionConfig(kind="int8+topk"),
        reputation=ReputationConfig(enabled=True, quarantine_rounds=1000,
                                    w_anomaly=1.0),
        faults=FaultPlan(seed=11, byz_peers=(2,), byz_prob=1.0,
                         byz_behaviors=("scale", "digest_forge")),
        dist=DistConfig(peers=3, buffer=3, buffer_timeout_s=20.0,
                        idle_timeout_s=150.0, peer_deadline_s=240.0,
                        checkpoint_every_versions=1))
    result = run_dist(cfg, str(tmp_path / "run"), deadline_s=270.0,
                      device="cuda", threads=1, kill_peer=0,
                      kill_after_version=4)
    assert result["ok"], result["log_tails"]
    reports, kill = result["reports"], result["kill"]
    assert kill is not None and kill["restarted"]
    leader = reports[0]
    assert leader["resumed"] and leader["device"].startswith("cuda")
    for p in range(3):
        assert reports[p]["reputation"]["state"][2] == "quarantined"
        assert reports[p]["chain_ok"]
    assert leader["reputation"]["quarantine_drops"] > 0
    assert reports[2]["byzantine"]["total"] > 0
    assert reports[0]["byzantine"]["total"] == reports[1]["byzantine"][
        "total"] == 0
    restored = leader["restored_reputation"]
    state = torch.load(os.path.join(kill["kept"], f"round_{kill['round']:06d}",
                                    "state.pt"), weights_only=True)
    assert leader["restored_from_version"] == kill["round"]
    assert restored["trust_hex"] == [float(t).hex()
                                     for t in state["rep_trust"].tolist()]
    assert restored["state"][2] == "quarantined"
    # K4/K5 in both of the leader's CUDA contexts, the resumed one too
    dead = result["incarnation_reports"][0]
    for r in dead + [leader]:
        assert r["kernel_launches"]["int8_quantize"] > 0
        assert r["kernel_launches"]["topk_select"] > 0
    assert len({r["chain_head"] for r in reports.values()}) == 1
    col = collate_run(result["run_dir"])
    assert col["ok"], col["violations"]
    assert col["invariants"]["no_quarantined_merge"] == 0


@pytest.mark.gpu
def test_gossip_merge_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the merge runs on the card)")
    import numpy as np

    from bcfl_tpu_torch.dist.gossip import merge_states, state_digest
    from bcfl_tpu_torch.models import build
    from bcfl_tpu_torch.models.convert import trainable_tree

    with torch.device("meta"):
        shapes = {p: tuple(x.shape) for p, x in trainable_tree(
            build("biobert-base", num_labels=40, vocab_size=28996)).items()}
    gen = torch.Generator().manual_seed(0)
    items = []
    for p in range(3):
        state = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
        items.append({"peer": p, "order": (1, p), "state": state,
                      "vv": np.asarray([3 - p, p, 1], np.int64),
                      "mass": 2.0 - 0.5 * p, "trust": 1.0 - 0.1 * p})
    cpu, vv_c, w_c = merge_states(items, 0.9)
    gpu_items = [dict(it, state={k: v.cuda() for k, v in it["state"].items()})
                 for it in items]
    gpu, vv_g, w_g = merge_states(gpu_items, 0.9)
    assert w_c == w_g and vv_c.tolist() == vv_g.tolist()
    for k, v in cpu.items():
        assert gpu[k].is_cuda
        assert torch.equal(gpu[k].cpu(), v), k
    assert state_digest(gpu) == state_digest(cpu)


@pytest.mark.gpu
def test_chaos_lanes_over_card_frames(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the peers run K4/K5 on the card)")
    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.config import (DistConfig, FedConfig, LedgerConfig,
                                       PartitionConfig)
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.faults import FaultPlan
    from bcfl_tpu_torch.ops import cuda_build
    from bcfl_tpu_torch.telemetry import collate_run

    cuda_build.build_all()
    cfg = FedConfig(
        name="chaos_gpu", runtime="dist", mode="server", sync="async",
        model="tiny-bert", dataset="synthetic", num_clients=4, num_rounds=4,
        seq_len=32, batch_size=8, max_local_batches=2, eval_every=0,
        partition=PartitionConfig(kind="iid", iid_samples=16),
        ledger=LedgerConfig(enabled=True),
        compression=CompressionConfig(kind="int8+topk"),
        faults=FaultPlan(seed=3, wire_drop_prob=0.3, wire_dup_prob=0.3,
                         wire_reorder_prob=0.3, wire_reorder_hold_s=0.2,
                         wire_corrupt_prob=0.2, limp_peers=(1,),
                         limp_prob=0.5, limp_stall_s=0.2,
                         limp_throttle_bps=float(1 << 22)),
        dist=DistConfig(peers=2, peer_deadline_s=200.0, suspect_after=1,
                        checkpoint_every_versions=0))
    result = run_dist(cfg, str(tmp_path / "run"), deadline_s=240.0,
                      device="cuda")
    assert result["ok"], result["log_tails"]
    reports = result["reports"]
    for p in (0, 1):
        r = reports[p]
        assert r["chain_ok"] and r["device"].startswith("cuda")
        assert r["kernel_launches"]["int8_quantize"] > 0
        assert r["kernel_launches"]["topk_select"] > 0
    assert reports[0]["chain_head"] == reports[1]["chain_head"]
    injected = sum(sum(r["transport"]["chaos_injected"].values())
                   for r in reports.values())
    assert injected > 0
    arrivals = [a for m in reports[0]["merges"] for a in m["arrivals"]]
    assert arrivals and all(a["auth"] == [1.0, 1.0] for a in arrivals)
    col = collate_run(result["run_dir"])
    assert col["ok"], col["violations"]
    assert col["timeline"]["merges"]["arrivals"] == col["timeline"][
        "merges"]["unique_update_ids"]


@pytest.mark.gpu
def test_gossip_partition_heal_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the peers merge on the card)")
    from bcfl_tpu_torch.config import (DistConfig, FedConfig, LedgerConfig,
                                       PartitionConfig)
    from bcfl_tpu_torch.dist import run_dist
    from bcfl_tpu_torch.faults import FaultPlan
    from bcfl_tpu_torch.reputation import ReputationConfig
    from bcfl_tpu_torch.telemetry import collate_run

    cfg = FedConfig(
        name="gossip_gpu", runtime="dist", mode="server", sync="async",
        model="tiny-bert", dataset="synthetic", num_clients=6, num_rounds=4,
        seq_len=32, batch_size=8, max_local_batches=2, eval_every=0,
        aggregator="trimmed_mean",
        reputation=ReputationConfig(enabled=True),
        partition=PartitionConfig(kind="iid", iid_samples=16),
        ledger=LedgerConfig(enabled=True),
        faults=FaultPlan(partition_groups=((0, 1), (2,)),
                         partition_rounds=(1, 2)),
        dist=DistConfig(peers=3, dispatch="gossip", gossip_fanout=2,
                        peer_deadline_s=200.0, idle_timeout_s=120.0))
    result = run_dist(cfg, str(tmp_path / "run"), deadline_s=240.0,
                      device="cuda", threads=1)
    assert result["ok"], result["log_tails"]
    for p, r in result["reports"].items():
        assert r["dispatch"] == "gossip" and r["device"].startswith("cuda")
        assert r["final_version"] >= cfg.num_rounds and r["chain_ok"]
        assert r["gossip"]["fork"]["component"] == (
            [0, 1] if p in (0, 1) else [2])
    col = collate_run(result["run_dir"])
    assert col["ok"], col["violations"]
