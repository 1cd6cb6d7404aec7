"""Adversarial-peer injection for the dist runtime, the byzantine lane:
port of ``bcfl_tpu/dist/byzantine.py``.

A :class:`ByzantineAdversary` rewrites its own peer's outbound updates
ABOVE the wire: every frame is well-formed, CRC'd, acked and deduplicated,
and the transport delivers the lie intact. What catches it is the
application layer: the leader's refingerprint of what arrived (ledger
evidence), the robust buffered merge (outlier evidence), the lineage
checks (replay evidence), and :class:`bcfl_tpu_torch.reputation.dist.
DistReputationTracker`, which folds the evidence into quarantine.

Behaviors, drawn per (peer, round) by :meth:`FaultPlan.byz_action`:

- ``scale`` / ``sign_flip`` / ``garbage``, poisoning: the payload's float
  parts are scaled, negated or replaced with seeded noise, and the caller
  re-announces digests over the poisoned payload, so ledger
  authentication PASSES (only the robust merge sees these);
- ``digest_forge``: the honest digests are announced and a scaled
  payload shipped, so the leader's refingerprint fails;
- ``replay``: an earlier honest update (header and payload, recorded at
  send time) is resent under a fresh transport identity;
- ``equivocate``: each destination's payload carries destination-keyed
  noise under one announced digest.

The wire tree is a (nested) dict of CPU tensors. A float leaf is mutated
through numpy with JAX's own expressions and draws
(``rng.standard_normal`` in float64, cast to the leaf dtype), visiting the
keys in sorted order, so the mutated bytes equal JAX's for the same
``(plan seed, round, peer, destination)``. A bfloat16 leaf passes through
untouched, as in JAX, where ``np.issubdtype(bfloat16, np.floating)`` is
False. A disabled lane returns the caller's objects themselves.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bcfl_tpu_torch import telemetry
from bcfl_tpu_torch.faults import FaultPlan

# the float dtypes numpy holds (JAX's np.floating leaves); bfloat16 is not
# among them
_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def _map_floats(tree, fn):
    """Apply ``fn`` (numpy array -> numpy array) to every float leaf of a
    (nested dict) tree of tensors, keys in sorted order; int leaves
    (quantized codes, indices) and bfloat16 leaves ride along untouched.
    The visit order is part of the determinism contract: ``fn`` consumes
    seeded draws per leaf."""
    if isinstance(tree, dict):
        return {k: _map_floats(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, torch.Tensor) and tree.dtype in _NUMPY_FLOATS:
        out = np.asarray(fn(tree.detach().cpu().numpy()))  # 0-d stays 0-d
        if not (out.flags.c_contiguous and out.flags.writeable):
            out = np.array(out)
        return torch.from_numpy(out)
    return tree


class ByzantineAdversary:
    """Binds the plan's byzantine lane to ONE peer process:
    :meth:`corrupt_update` is the one injection seam, an identity for
    honest peers and disabled lanes. ``clock_fn`` is the peer's local
    round."""

    #: how many of its own past sends the adversary remembers for replay
    REPLAY_DEPTH = 8

    def __init__(self, plan: Optional[FaultPlan], peer_id: int,
                 clock_fn: Callable[[], int]):
        self.plan = plan if plan is not None else FaultPlan()
        self.peer_id = int(peer_id)
        self.clock_fn = clock_fn
        # (header, wire_tree) of past HONEST sends, oldest first: the
        # replay corpus (deep copies: a replayed header carries the
        # original round, base version and lineage)
        self._history: List[Tuple[Dict, Dict]] = []
        self.injected: Dict[str, int] = {b: 0 for b in
                                         self.plan.byz_behaviors}

    @property
    def armed(self) -> bool:
        return (self.plan.byz_enabled
                and self.peer_id in (self.plan.byz_peers or ()))

    def corrupt_update(self, header: Dict, wire_tree: Dict,
                       dst: int) -> Tuple[Dict, Dict, Optional[Dict]]:
        """Maybe rewrite one outbound update bound for peer ``dst``:
        ``(header, wire_tree, None)`` with the caller's own objects when
        the peer behaves this round, else fresh mutated copies and the
        drawn action, whose ``reannounce`` says whether the caller must
        recompute the announced digests over the mutated payload (the
        poisoning behaviors)."""
        rnd = int(self.clock_fn())
        act = self.plan.byz_action(rnd, self.peer_id)
        if not self.armed or act is None:
            # honest this round: replay corpus, objects passed through
            if self.armed:
                self._remember(header, wire_tree)
            return header, wire_tree, None
        behavior = act["behavior"]
        scale = act["scale"]
        rng = self.plan.byz_rng(rnd, self.peer_id, int(dst))
        if behavior == "replay" and not self._history:
            # nothing recorded yet: behave honestly this round (recorded as
            # corpus) rather than substitute a behavior the plan excluded
            self._remember(header, wire_tree)
            return header, wire_tree, None
        out_header, out_tree = dict(header), wire_tree
        reannounce = False
        if behavior == "scale":
            out_tree = _map_floats(wire_tree,
                                   lambda a: (a * scale).astype(a.dtype))
            reannounce = True
        elif behavior == "sign_flip":
            out_tree = _map_floats(wire_tree, lambda a: -a)
            reannounce = True
        elif behavior == "garbage":
            out_tree = _map_floats(
                wire_tree,
                lambda a: (rng.standard_normal(a.shape) * scale).astype(
                    a.dtype))
            reannounce = True
        elif behavior == "digest_forge":
            # honest digests announced, a poisoned payload shipped
            out_tree = _map_floats(wire_tree,
                                   lambda a: (a * scale).astype(a.dtype))
        elif behavior == "equivocate":
            out_tree = _map_floats(
                wire_tree,
                lambda a: (a + rng.standard_normal(a.shape)).astype(
                    a.dtype))
        elif behavior == "replay":
            old_header, old_tree = self._history[0]
            # the stale header verbatim; the transport stamps a fresh
            # message identity
            out_header = dict(old_header)
            out_tree = copy.deepcopy(old_tree)
        # every round's honest input feeds the replay corpus
        self._remember(header, wire_tree)
        self.injected[behavior] = self.injected.get(behavior, 0) + 1
        telemetry.emit("byz.inject", behavior=behavior, round=rnd,
                       dst=int(dst), reannounce=reannounce)
        return out_header, out_tree, dict(act, behavior=behavior,
                                          reannounce=reannounce)

    def _remember(self, header: Dict, wire_tree: Dict) -> None:
        self._history.append((copy.deepcopy(header),
                              copy.deepcopy(wire_tree)))
        while len(self._history) > self.REPLAY_DEPTH:
            self._history.pop(0)

    def stats(self) -> Dict:
        """Per-behavior injection counts for the peer report."""
        return {"armed": self.armed, "injected": dict(self.injected),
                "total": int(sum(self.injected.values()))}
