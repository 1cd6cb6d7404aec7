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
