"""The port's ``PeerTransport`` against the JAX package's, over loopback:
frames cross both ways between a JAX transport and a port transport with
their trees bit for bit, a resent ``(from, msg_id)`` is deduplicated, and
both failure detectors walk the same state sequence as JAX's for the same
script of outcomes."""

import time

import numpy as np
import pytest
import torch

from bcfl_tpu.config import DistConfig as JDist
from bcfl_tpu.dist import transport as jt
from bcfl_tpu.dist.harness import free_ports
from bcfl_tpu_torch.config import DistConfig
from bcfl_tpu_torch.dist import transport as tt

pytestmark = pytest.mark.dist

POLICY = dict(send_deadline_s=5.0, retry_base_s=0.01, retry_max_s=0.05)


def _recv(tr, timeout=10.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        msg = tr.recv(timeout_s=0.1)
        if msg is not None:
            return msg
    raise AssertionError("no frame arrived")


@pytest.fixture
def pair():
    """Peer 0 is a JAX transport, peer 1 the port's."""
    ports = free_ports(2)
    addrs = [("127.0.0.1", p) for p in ports]
    j = jt.PeerTransport(0, addrs, policy=JDist(**POLICY), epoch=11)
    t = tt.PeerTransport(1, addrs, gate=tt.PartitionGate(None, 2),
                         policy=DistConfig(**POLICY), epoch=22)
    j.start()
    t.start()
    yield j, t
    j.close()
    t.close()


def _trees(seed):
    rng = np.random.default_rng(seed)
    payload = {"layer/kernel": {
        "q": rng.integers(-127, 128, (2, 3, 8)).astype(np.int8),
        "scale": rng.random((2, 3)).astype(np.float32),
        "idx": rng.integers(0, 1000, (2, 24)).astype(np.int32)},
        "bias": {"vals": rng.normal(size=(2, 5)).astype(np.float32)}}
    return payload


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _equal(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        if isinstance(j[k], dict):
            _equal(t[k], j[k])
        else:
            a = t[k].numpy() if isinstance(t[k], torch.Tensor) else t[k]
            assert a.dtype == j[k].dtype and a.shape == j[k].shape
            assert a.tobytes() == j[k].tobytes(), k


@pytest.mark.parametrize("pipelined", [False, True])
def test_frames_cross_both_ways_bit_for_bit(pair, pipelined):
    j, t = pair
    payload = _trees(0)
    header = {"type": "update", "base_version": 2, "n_ex": [4, 4]}
    # port -> JAX
    send = t.send_async if pipelined else t.send
    assert send(0, header, {"payload": _torch(payload)})
    got_h, got_t = _recv(j)
    assert got_h["from"] == 1 and got_h["msg_epoch"] == 22
    assert {k: got_h[k] for k in header} == header
    _equal(got_t["payload"], payload)
    # JAX -> port: tensors on arrival
    send = j.send_async if pipelined else j.send
    assert send(1, header, {"payload": payload})
    got_h, got_t = _recv(t)
    assert got_h["from"] == 0 and got_h["msg_epoch"] == 11
    assert isinstance(got_t["payload"]["bias"]["vals"], torch.Tensor)
    _equal(got_t["payload"], payload)
    if pipelined:
        assert t.flush_sends(5.0) and j.flush_sends(5.0)
        assert t.stats()["pipeline"]["async_enqueued"] == 1
    for tr in (j, t):
        assert tr.stats()["send_failures"] == 0


def test_resent_message_is_deduplicated(pair):
    j, t = pair
    header = dict({"type": "ping", "from": 0, "msg_id": 7, "msg_epoch": 11})
    # the JAX sender delivers the same (from, epoch, msg_id) twice: the
    # port's receiver acks both and hands one to the application
    assert j._send_reliable(1, header, None, None, time.time())
    assert j._send_reliable(1, header, None, None, time.time())
    assert _recv(t)[0]["msg_id"] == 7
    time.sleep(0.3)
    assert t.recv(timeout_s=0.2) is None
    assert t.stats()["dups_dropped"] == 1
    # and the other way round
    header = dict({"type": "ping", "from": 1, "msg_id": 3, "msg_epoch": 22})
    assert t._send_reliable(0, header, None, None, time.time())
    assert t._send_reliable(0, header, None, None, time.time())
    assert _recv(j)[0]["msg_id"] == 3
    assert j.stats()["dups_dropped"] == 1 or j.recv(timeout_s=0.5) is None


def test_dedup_window_and_epochs_match_jax():
    a = tt.PeerTransport(0, [("127.0.0.1", 1)],
                         policy=DistConfig(dedup_window=4))
    b = jt.PeerTransport(0, [("127.0.0.1", 1)], policy=JDist(dedup_window=4))
    script = [(1, 5, 0), (1, 5, 0), (1, 5, 3), (1, 5, 9), (1, 5, 4),
              (1, 5, 5), (1, 6, 0), (1, 5, 10), (1, 6, 0), (2, 1, 0)]
    assert ([a._dedup_accept(*s) for s in script]
            == [b._dedup_accept(*s) for s in script])


def _script_states(det, script):
    out = []
    for peer, ok in script:
        (det.on_success if ok else det.on_failure)(peer)
        out.append(det.state_of(peer))
    return out


SCRIPT = [(1, False), (1, False), (1, False), (2, False), (1, True),
          (1, False), (1, False), (1, False), (1, False), (1, False),
          (1, False), (1, False), (2, True), (1, True), (2, False),
          (2, False)]


def test_fixed_detector_walks_jax_states():
    t = tt.FailureDetector(3, suspect_after=2, down_after=5)
    j = jt.FailureDetector(3, suspect_after=2, down_after=5)
    assert _script_states(t, SCRIPT) == _script_states(j, SCRIPT)
    assert ([(x["peer"], x["from"], x["to"]) for x in t.transitions]
            == [(x["peer"], x["from"], x["to"]) for x in j.transitions])


def test_phi_detector_walks_jax_states_under_failures():
    t = tt.PhiFailureDetector(3, phi_suspect=2.0, phi_down=6.0)
    j = jt.PhiFailureDetector(3, phi_suspect=2.0, phi_down=6.0)
    assert _script_states(t, SCRIPT) == _script_states(j, SCRIPT)
    for det in (t, j):
        det.note_rtt(1, 0.01, 1 << 20)
    assert t.send_budget_s(1, 1 << 24) == pytest.approx(
        j.send_budget_s(1, 1 << 24))


def test_partition_gate_is_the_no_plan_identity():
    g = tt.PartitionGate(None, 3)
    j = jt.PartitionGate(None, 3, lambda: 0)
    assert g.components() is j.components() is None
    assert g.component_of(2) == j.component_of(2) == (0, 1, 2)
    assert g.allowed(0, 2) and j.allowed(0, 2)
