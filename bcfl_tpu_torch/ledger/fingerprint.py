"""Device-side parameter fingerprints for the ledger: port of
``bcfl_tpu/ledger/fingerprint.py``.

The content digest of each client's update is a compact weighted fold
computed on the tree's device, so only ``[C, K]`` floats reach the host;
the SHA-256 chain then hashes those fingerprint bytes plus a structure
digest over leaf names, dtypes and shapes. Construction (the JAX
package's):

1. each leaf ``x`` is viewed as ``[C, M, LANES]`` (float32, zero-padded to
   ``LANES = 128``),
2. folded over ``M`` with per-leaf position weights ``cos(a*m + b),
   sin(a*m + b)``, ``(a, b)`` from the SHA-256 of the leaf's path name ->
   ``[C, 2*LANES]``,
3. the leaves' folds are summed and multiplied by one fixed standard-normal
   projection ``[2*LANES, K]`` -> ``[C, K]``.

The projection is JAX's ``jax.random.normal(jax.random.key(0xBCF1), (256,
4))``, kept here as its float32 bytes (:data:`PROJECTION_B64`); a CPU test
holds the copy to JAX bit for bit. Leaves fold in the JAX flatten order
(:func:`~bcfl_tpu_torch.ledger.ledger.flat_leaves`), several leaves per
product. The fold and the projection are plain ``torch`` ops, as they are
plain XLA ops in JAX, so the port's fingerprint rows equal JAX's within
float32 summation order, not bit for bit; inside the port they are deterministic on a device (the
same tree gives the same bits), which is what authentication compares.

This is a content fingerprint for tamper evidence in a cooperative audit
chain, not a MAC: byte hashing (:func:`~bcfl_tpu_torch.ledger.ledger.
params_digest`) stays available.
"""

from __future__ import annotations

import base64
import hashlib

import numpy as np
import torch

from bcfl_tpu_torch.core import to_device
from bcfl_tpu_torch.ledger.ledger import _sha256_chunks, dtype_str, flat_leaves

K = 4  # fingerprint floats per client; 16 bytes of content evidence/entry
LANES = 128  # fold width (the TPU lane count of the JAX package)

#: float32 little-endian bytes of ``jax.random.normal(jax.random.key(
#: 0xBCF1), (2 * LANES, K), jnp.float32)``, row-major
PROJECTION_B64 = (
    "wY80QDESF7+pqbA9F0+xP1vnar61xqo/M8NdPpZpB75jDEk/xLwGvyzK0j5SGj4/l/60PmNq"
    "H79T/9+/Si/hPyuxmz5vq2u+DfYcP46zwz/uymo/lljavm6A6j+hshA/Brq6PyA/Kz4Row/A"
    "qEuBvzpCN78MIYO+124+vxVMDkBYIM29vqYcP2gpqL/sLce+s7aCP2mdlj00SYg/ye9Kv/44"
    "6j8Cn7w/ekEBv89aHb8+QAE/e58EP/F9tz5vzim/8uxov0Vqwr4wbCC/BlPIPaVQ6z2MwR4+"
    "b/C3PqCmI738euu+rdCOP1bkrj878p0/YeQUPw/eCD+sx9O/dQ4vvjnpVT/DMbk9EYduv1MI"
    "3j67+wW/bYwJwHZaDj/Ro0S/aaUlPj78Aj4McnS97muaPmgCQL9xnAq/8+c7v6oPvr/ldaq9"
    "i9/svjEvfj80WzM/PqW3PkrZmz5AtW8/jqSzP9DdTb8cSWS/Qe5nP7srzr5ZABi+Vfi8PVN+"
    "9D7hMDU/Hx4wPhcHBb/rEX0+1lCUv3EelL714o6/ZmL7v1VvjT+VS7q/ToyBv2ACCECAuwI/"
    "Q132PwzoUD8kyiI/52EFQNsYKL+3VSJAOzYrPr+zqD2ycjS/kLhkv08cvL1yEpE/tEvHPyJV"
    "6rxvQhC/Rys+vRGp5D+34Y++XiGCv43Ns7/xp34/2Or4v9INDb8pL4C/AnVYvzgwyL7W4T69"
    "Xi1EPu4oFj/iw4u+LamXv/rbWj9p8+M+ZlB0v9mc1z90GDw/5Vcdv9i9+L7lNpM/UhGGP7q2"
    "Nz9ba8S+qG/tP2cz2z5ifwa+RuQIPwq9yD+UfFy/uA/qP1MQPD9Ra6Q/of7IvwiRwz48Ud2+"
    "bNxuv7mgkT8346s+2Hm3PyZGdz5pyo0/OXuDPxJSrr8e2Fq/5NvWPiGtfD7wV9I/AoaTv0ir"
    "ID8s4CS/zQqgvoWsw76yP1M/AQkvvwA2kL+6OtS/ye4tPdmawT8r2kS/ZsXEPuWDRD/y5RS/"
    "vuu2P18/vL5g0ca+QcQ5PyJ2pr/a/Ei+HaAwPUgLBj/owG2/PgpTvoQ4Zr+ZXE2/FxFYvwhI"
    "Hj8eIju+PiY8PmQ3Qj8rgkq/1hZNP2GCnTwDkkS/5heMP04Isr9bpbK9luHGP9+DmT7KwTC/"
    "x8DDvxPa7D9YQz2/q+SHv2MUvr6W3rk/6udIv3EinD98NPC8h1ocv0f9TD4vM8C+4ieUv4C2"
    "Xr/85uo/ldSUv3Dxwz6umjPAXN49P9t9ez+ABZW/lJGuvsTtBr6LQlo/Q8y+PfMMRj7dc2Y/"
    "U9FUPvRFdj6Hl3Y/hmA/P3eyyb3eLg6+wbnyvk7aaz2vQxO/sWQZv5GkXz8Omo++aPqnvwyk"
    "8b7uyTc/IzQFP+URkD6C+N6/LAyQP5H6nL8B2Y0/gGSVvhqhp79net8/95aLP3j8Sb8WPd6/"
    "p1kqPhoTTL5Pe64+ICzsv7VRrD+6koQ/dKU2vtoiDr9YUla/2ZkTvtVQ3T25GpA/kOKivr3y"
    "QD7sa9k+3jsYPkKlCT5r9AXAqXnevluMxr0keAA+QhtKP/cZJT/w386/wsHJvgproj7kjsY+"
    "UAoUwBSxqj32FNQ/1jyiPaY6n78e5Ga+lHnMPq/v5r6Wphg/xZALP6qjWL/7SALAnAvFv8f/"
    "AT6UVry/ZdLjvgbjCT+8r9C/RJVMvpIuWz/ORyW+HEzfP9okHUBhvuu+W4Civge5i76l34e/"
    "PzlVPWwE5T2qoYg/D08VwCMIjT6c3RpAvyEIwHCBfT+JMOK+NFWtv8oC4D8EC6g/EioJwP9H"
    "zD4/81c/5dN6v0sTpj0KMxM/nC86v76+3b+6T/q94sWLvz6Dpz8ZbJI/VTxzP9s9zb9/h7E+"
    "ykmQv9Cv0T+QSV8/03B1v0x0gD6qVNe/vZxGvzOiuj5FVUO/QKwAwGjnNsAYcIA/XxxWvxpI"
    "AkCgQVM/tb0DvvelHD9pJF2/kE2VPQSw1L+BIDY+rvcQwEVXH77G+dc+zc5KP1AdZj5LYfK9"
    "FXNJvUySWL9eZT6/rlmWv/yRSz/0iIe9llOJv7d+pT633lu/7nInPz8k/j+Al/s9eGQTvEcW"
    "wb7EFpy+ZITsPgmB676aMKE/t2Kmv1l+nD8kNJu+fjWaPJmLub+ziGO+93quv3ytzb6TDIu/"
    "Nq4bvrIgUz4FPcC+3Dl8PxKQWz6FUYG9nQCSPwztKz9aGWk/dZaLPqREm7/wSAG+lnOWvmUi"
    "DMAO2sm/3f6Fvzh9dj8KQ6Y/aWNxPzTC2r51FXm+ALWBv87enT8/bYI+tWosP/c3Dz419AHA"
    "2Y3gvmIuP7/Np4S/W/Nbv6T4L75aWWe/NX8yv27Ztb+k5B8/yxZZP76uDEDo10G/TQKWO6ro"
    "Rr8Zqm8+pxVBP6HhPz+qHX2/YPKBP86zkz9dOPY+H16CP4SNxj98qrK+f68uQHTldz+ird4/"
    "5NA1P/8wEEAaJ5U/6JgwwHpMS76CNTS/4SjgvjH3qr8g+jG/FGLfv5N8qT5GYAA/xWEDQCBE"
    "rT9yjWg9UC+EvweWWr8RjifAqJoOQGNZbb84j9g+yWS4P3t85T6yMNa/tKsRQFh9a76ArEe/"
    "D85bv0PtYr5zxbW+9r4HP4Ebtz+ZNi6/itygPmXvKj+3ZKc+Dc0Gv9wYjT5Li1Q+VJ+xPtrt"
    "gz90lzG/B/yjPhEuyb5KHji/VhyJP8F/DD5l6IW+aWgDPZGg/b7hEFY/zjhqPwEj5b4EbpC+"
    "8oqivm8/kD81HDk/HOZOvgeYFT+/Qb6+0plGP0VnlT9VdIc+UgVKv7xw976G5aq+vpp9v7ri"
    "mj9ozae+Vjc7P1V9iL/lLqa/sbjVvrZDSb0tpze+1wgDvmZMWT+E/z4/ppVLv19HFb+W83K/"
    "GtiNPqQs1T+OBwC/F0KOPlS/u710F6a+Z9iTvl1uyb+2Ogk+0dvmPw+1Oz8/jOI+BIdaPzc1"
    "uL1qLIW+eTRFv6LiuL4JTx3AZhREv/Npcj9GMzs/wDi3P9hkLz/kjIW+SqDSvthxuL+WPuc+"
    "ndkHvflOGcAmekC+LkSgP/QsfL+9pYG/QJoQP4oaG7/MmR7A++yOv3p9DD/mOO2/GdqavqMM"
    "gb8NTaW/sdPmvd5jBL+BcEK/cf6FvmfZkz7eD6c/b0wLvz4b1T6C2uE9b24KP9xwC0C7mt2/"
    "2KvkvixFnj+NR+I8ECW0PhPRhL8kxEO/A9ZjP6Cssb8Jkzi/yPzov/Bm1T6r1Ty/01VbP3nr"
    "yz6YfMw+cYnqPu/sf771uzK/IfDIPVoS9z5IL4a+h4K3Prlw2T67kmC/ZB0ZP4qB875nAi6/"
    "lBcVQEp+LT+q7Sq9fk7IvxQviT2UTQI/DLw3PyfDrz75P4M/2NvPv/dQZz+7cM8/GVEQQG9l"
    "Yj2XRyC/ThmOPix3uT4WAx8/P5s+vwjrNL9kEVE/YgvAviOvNzyv93G+kPuwPotnI7/aWuS+"
    "D5AePy+4pz6X/ja/TZcQv9YgGD+CMV6+koyJv2PGar/9Eps+Fr05vs6Kkr8kOJQ/mookvc14"
    "Mj8r0OS94X7Pvzu4h78142E9KsEGPrwFCT+yApY/jrB2PmCX8T6gNoG/QjIqPgXtnD/4fmy/"
    "vPV0vsSucz9W0Lk/UhCKvvIgpL+5Hwm+1lNyv2Uz/b4My02+JGinvGpzL79AngQ/QFkSv3DP"
    "Vr+7ATq+KBKpvxp71T6CV2g+mpG1vkLbHT5qQC09ZpU4v0vSqb9eS3k/R6b7vmvqoD+c17o+"
    "Mb6GPzBckj8B6bm+tkkBv6+9KT+N98O/AoXLPi2hPD8FI5i/CO1gvSRo978LpbU/VHHbvkGd"
    "C78Fs5Q/g+86vzPokj81Acc+1KU1vWHMbT+QSg+/456eP23Bh76RaP2/02cjP41Glj/jV8m/"
    "oLZIPiy6cz4ubNS/DDYwP1itHz+0eH0/xp7gPksWlD9Qmak6K/ALQMBzdb0yQfA+claZPXqS"
    "G0AYfiU/1fnAPlXde767kTm/N6z2vGQopz8eMb++Nsx7vhvSPT85WuQ+sWLIv97q7L8HpCy+"
    "9wqfP/m3Ij94SQA/MZ+Yvgjlxj/tzr0/LG1/v1MIA7+LyXU8L7/Lv88O+78LY4G+bzyMvpsp"
    "1D/QKxu/5+dbPzAnKj+8rTs/drbjv+DD/b20UgI/EBr0vqvRoj92cbO+a0OLPl6yHb1ftUZA"
    "o8vMvVdiHL9gOFs8+pjzPllbCj+hgKS/8vkQPjDK1j7C75c+uHCOv4dcOz9Fivs8o9o6PuvA"
    "y78Zaeg/LZlNP6KO/7/hSlC/9L+Pv+clT745G2E/fqRBP8B+0r5qh4A+cX7rPop2Tb8KDp6+"
    "tlSaPwSrFz7DWP+/UNxKPRiaqD8rTSQ+Y56Jv3fJiT+Hhxq+3aKavDb7cz8EJ6w+r+9+vj5h"
    "nL7va9I+1hX/vtSIZj+Chj0/WUmFP5WhCj4bL26/PJyyv1gJqj2lUGu/JXUkv9XmWz91Kvo+"
    "mpQkPx/GQz8vSEM/b/5mPp+GSz+zbKs/Dx6ZviCw8L/w7Y2/gX8aQFRW+bz4iSg+x2NVvy0r"
    "yz8L8bA+PaOFPvrbWj84zRM/84BqP4lkA76Mcr8/BXSnv1IdQ79LSuU+MS2cv7fIJ79Br4e+"
    "bNyvP8HL7T0T/7w+StTYvoXrqb8U4ok/bNdEP02/ZL51i3u/Ke4bP2eShD3ugfK+stU6Pm6k"
    "hj0r3Io/yexbv9bb8rtNwgG9RHamPxoP57+alDO/XtvTP24Hbj9Nl02/PpovPVZzyb76dDpA"
    "Cu6nvxHpjD/JPJG/7/xzP3FG8r6PEvw+T/72vjYf/j0FsFw+0RuOv/uKkL8Rw5m+q8RIvw2u"
    "Qb8zGbs/3HHvv5/cWj+hNqU+RtYaP9k0/j/qBSq9nzlEQOyehj+EatQ+r5MFv4S+3j5b+QxA"
    "E0rDvqFh6T/GidK/GwsTPl/F3b9l+g2/knC/PHoQvT7duJK+j1p1v182LT9Bh2c/IVSWP1Zd"
    "RD/RvJa/cXzWPhpy3j6BPYk+dqOlvXdG8L5KepY/lKJvP/iHjT96yL6/bYKYP/rYrz+gEJ2+"
    "SwiWvwfdy7/Ks+Y+Tq5oPzknOT/dXXC/sZtLPofktb7HtVW/Q0GAPzpik7891MI/43ZdPzgV"
    "jL8Hjny/GQ7hPiBg1b4hO6M+hK5Ev5I7mD91i88+s4ujPjEr7T9/pDM/qMngvxpJw76lGF0+"
    "tcu7PkxBOL/DPKq/XoklwDMM6D7a5Ws/pnnIv1sBab9+DKo+LxglPfzbmr5OUg6+qvRHPzEN"
    "sT8x1tg/u9Y4P4jlfr+BZ7s/p9+Kvwxk/z9RPlK/rXAfP64HXj9L3ac+ZfK9v3l4dz5u+Oa9"
    "OYNavjSCwz9bFwDAewOQP5Kt6b2HmYK+RLPAPZGB+rv09IY/DLwvwF9wpr8bSH0+kZ0GvkVd"
    "K77YOwS+bBbhPhjQCj8kAShAJOcavZnAET/5pg2/RxbBvpjPD789Jky/eYsXPw=="
)


def projection(k: int = K, device=None) -> torch.Tensor:
    """The fixed ``[2*LANES, k]`` projection (only ``k = K`` exists)."""
    if k != K:
        raise ValueError(f"the fingerprint projection is [256, {K}], "
                         f"got k={k}")
    raw = np.frombuffer(base64.b64decode(PROJECTION_B64), dtype="<f4")
    proj = torch.from_numpy(raw.reshape(2 * LANES, K).copy())
    return proj if device is None else to_device(proj, device)


def _leaf_phase(name: str) -> tuple:
    """Per-leaf position-weight parameters (a, b), derived from the leaf's
    path name so sibling leaves fold differently."""
    h = hashlib.sha256(name.encode()).digest()
    a = 0.5 + int.from_bytes(h[:4], "little") % 100_000 / 100_000.0
    b = int.from_bytes(h[4:8], "little") % 628_318 / 100_000.0
    return a, b


#: elements per client a fold batch gathers before its product
_FOLD_BATCH = 1 << 24


def _phase(phases) -> torch.Tensor:
    """``[M]`` float32 ``a*m + b`` of a batch's positions, from its
    leaves' ``(a, b, m)``: host data, so it is computed on the host (built
    on a card, its sizes would have to be read back) in the float32 ops
    the card would run, which round alike on both."""
    ms = torch.tensor([m for _, _, m in phases])
    rep = lambda v: torch.repeat_interleave(  # noqa: E731
        torch.tensor(v, dtype=torch.float32), ms)
    starts = torch.cumsum(ms, 0) - ms
    idx = (torch.arange(int(ms.sum())) - torch.repeat_interleave(starts, ms)
           ).to(torch.float32)
    return rep([a for a, _, _ in phases]) * idx + rep(
        [b for _, b, _ in phases])


def _fold(xs, phases, C: int, dev) -> torch.Tensor:
    """``[C, 2*LANES]`` fold of a batch of leaves: ``xs`` their ``[C, m*LANES]``
    rows (zero-padded), ``phases`` their ``(a, b, m)``. One product over
    the batch's concatenated positions; each position's weights are the
    per-leaf ``cos(a*m + b), sin(a*m + b)`` in float32, as in JAX."""
    x = torch.cat(xs, dim=1).to(torch.float32)  # the cast of mixed dtypes
    phase = to_device(_phase(phases), dev)
    w = torch.stack([torch.cos(phase), torch.sin(phase)])  # [2, M]
    y = torch.tensordot(w, x.reshape(C, -1, LANES), dims=([1], [1]))
    return y.transpose(0, 1).reshape(C, 2 * LANES)


def client_fingerprint(stacked, k: int = K) -> torch.Tensor:
    """``[C, k]`` float32 fingerprint of a client-stacked tree (leaves
    ``[C, ...]``, any dtype), on the tree's device. The leaves fold in
    batches of about ``_FOLD_BATCH`` elements per client, one product each
    (a leaf at a time would cost a dozen small launches per leaf, most of
    a round's ledger time on a 200-leaf payload); the batching only
    reorders float32 sums."""
    flat = list(flat_leaves(stacked))
    if not flat:
        raise ValueError("cannot fingerprint an empty tree")
    lead = flat[0][1]
    C, dev = lead.shape[0], lead.device
    folds = torch.zeros((C, 2 * LANES), dtype=torch.float32, device=dev)
    xs, phases, size = [], [], 0
    for name, leaf in flat:
        x = leaf.reshape(C, -1)
        pad = (-x.shape[1]) % LANES
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        xs.append(x)
        phases.append(_leaf_phase(name) + (x.shape[1] // LANES,))
        size += x.shape[1]
        if size >= _FOLD_BATCH:
            folds = folds + _fold(xs, phases, C, dev)
            xs, phases, size = [], [], 0
    if xs:
        folds = folds + _fold(xs, phases, C, dev)
    return folds @ projection(k, dev)


def tree_fingerprint(tree, k: int = K) -> torch.Tensor:
    """``[k]`` fingerprint of ONE client's (unstacked) tree."""
    return client_fingerprint(_unsqueeze(tree), k=k)[0]


def _unsqueeze(tree):
    return {p: _unsqueeze(v) if isinstance(v, dict) else v[None]
            for p, v in tree.items()}


def struct_digest(tree, use_native: bool = True) -> bytes:
    """SHA-256 over the tree's leaf names + dtypes + shapes (no leaf
    data): binds a fingerprint to the structure. Leaves need only
    ``dtype`` and ``shape``."""
    chunks = [f"{name}:{dtype_str(leaf.dtype)}:{tuple(int(s) for s in leaf.shape)}"
              .encode() for name, leaf in flat_leaves(tree)]
    return _sha256_chunks(chunks, use_native)


def entry_digest(struct: bytes, fp_row, use_native: bool = True) -> bytes:
    """The 32-byte digest a fingerprint-mode ledger entry commits:
    ``SHA-256(struct_digest || fingerprint_bytes)``."""
    if isinstance(fp_row, torch.Tensor):
        fp_row = fp_row.detach().cpu().numpy()
    row = np.ascontiguousarray(np.asarray(fp_row, np.float32))
    return _sha256_chunks([struct, row.tobytes()], use_native)
