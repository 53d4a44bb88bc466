"""Leaf-key -> broker-shard partitioner + sharded tree encoding (DESIGN.md §11).

MLLess scales its external store by sharding keys across Redis instances
(paper §5; ``CommModel.n_redis`` already charges for it).  This module is
the live-runtime analogue: it owns the ONE deterministic assignment of
pytree leaf keys to broker shards that every party — each worker process,
the supervisor, and the tests — must compute identically from nothing but
the workload's parameter template and the shard count.

Properties the assignment guarantees (property-tested in
``tests/test_runtime_sharded.py``):

* **total**: every key is owned by exactly one shard in ``[0, n_shards)``;
* **deterministic / pool-independent**: a pure function of the
  (key, size) multiset and ``n_shards`` — independent of key order,
  worker-pool size, or process identity (no Python ``hash``, which is
  salted per process);
* **balanced**: greedy least-loaded placement over keys sorted by
  (size desc, key asc), so ``max_shard_bytes <= total/n + max_leaf_bytes``
  (the classic list-scheduling bound — tight enough that PMF's two
  embedding matrices land on different shards at ``n_shards == 2``).

``encode_tree_sharded`` is the worker-side producer: one codec pass per
leaf (``repro.wire``), grouped into per-shard (meta, buffer-views)
messages, with the optional fp32 quantization-error residual assembled
across all shards.  ``predict_shard_nbytes`` is the simulator/test-side
accountant: per-shard wire bytes through the same ``leaf_nbytes`` formula
the encoder asserts against, so broker-measured == simulator-accounted
bytes *per shard* by construction (§10's invariant, sharded).

**Oversized-leaf splitting** (``split_bytes > 0``): a model like PMF has
two embedding matrices and nothing else, so beyond two shards the greedy
partition degenerates — extra shards own zero update bytes.  With a split
threshold every leaf whose dense bytes exceed it is carved into
fixed-size flat chunks (element counts a multiple of 8, so bitmap masks
pack to identical totals) and the chunks are assigned independently.
The chunking is a pure function of the parameter template and the
threshold — NOT of the shard count — so wire bytes stay bit-identical
across topologies, and each *element* still lives on exactly one shard
with peers arriving in ascending worker order there: the per-element
float32 summation order, and therefore the final parameters, remain
bit-exact for any ``n_shards``.  ``tree_assignment`` warns when a shard
ends up owning zero bytes (raise the shard count past the chunk count
and the warning tells you the sweep is degenerate).
"""

from __future__ import annotations

import bisect
import hashlib
import warnings
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np

import torch

from repro_torch import tree as tree_lib
from repro_torch.wire import codec as wire_codec

PyTree = Any

#: Floor on the chunk byte size ``chunk_elems`` will honour.  Below this a
#: split threshold stops buying balance and starts exploding a large leaf
#: into thousands of subkeys, each paying per-chunk meta overhead — the
#: old floor was 8 *elements* (32 bytes of fp32), which silently turned a
#: 1 MB leaf into ~32k subkeys.
_MIN_CHUNK_BYTES = 1024

_warned_small_split = False


def assign_shards(
    keys: Sequence[str],
    sizes: Optional[Sequence[int]] = None,
    n_shards: int = 1,
) -> dict[str, int]:
    """Deterministic balanced assignment of leaf keys to shards.

    Greedy least-loaded over keys sorted by (size desc, key asc); ties on
    load go to the lowest shard id.  With ``sizes=None`` every key weighs
    1 (pure cardinality balance).
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    keys = list(keys)
    if len(set(keys)) != len(keys):
        raise ValueError("leaf keys must be unique")
    weights = [1] * len(keys) if sizes is None else [int(s) for s in sizes]
    if len(weights) != len(keys):
        raise ValueError("sizes must align with keys")
    order = sorted(range(len(keys)), key=lambda i: (-weights[i], keys[i]))
    load = [0] * n_shards
    out: dict[str, int] = {}
    for i in order:
        s = min(range(n_shards), key=lambda j: (load[j], j))
        out[keys[i]] = s
        load[s] += weights[i]
    return out


def _ring_point(label: str) -> int:
    """Position of a label on the hash ring: 64-bit blake2b.  Never
    Python ``hash`` — that is salted per process, and every party (each
    worker, the supervisor, tests) must compute the identical ring."""
    return int.from_bytes(
        hashlib.blake2b(label.encode(), digest_size=8).digest(), "big"
    )


def ring_assign(
    keys: Sequence[str], n_shards: int, vnodes: int = 64
) -> dict[str, int]:
    """Consistent-hash assignment of keys to shards.

    Each shard owns ``vnodes`` points on a 64-bit ring, labelled
    ``"shard<s>:<v>"`` — labels depend only on the shard id, never on
    ``n_shards``, which is what buys the consistency property: going
    N→N+1 adds shard N's points and steals only the keys that now fall
    in its arcs (expected 1/(N+1) of them), moving them *to* the new
    shard; going N→N-1 removes shard N-1's points and releases only its
    keys *to* the survivors.  Every other key keeps its owner, so a live
    re-shard migrates a minimal, provable fraction of the store.  A pure
    function of (keys, n_shards) — key order, sizes, and process
    identity are irrelevant.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    keys = list(keys)
    if len(set(keys)) != len(keys):
        raise ValueError("leaf keys must be unique")
    points: list[tuple[int, int]] = sorted(
        (_ring_point(f"shard{s}:{v}"), s)
        for s in range(n_shards)
        for v in range(vnodes)
    )
    ring = [p for p, _ in points]
    out: dict[str, int] = {}
    for k in keys:
        i = bisect.bisect_right(ring, _ring_point(k)) % len(points)
        out[k] = points[i][1]
    return out


def chunk_elems(itemsize: int, split_bytes: int) -> int:
    """Elements per chunk for a split leaf: ``split_bytes`` worth, rounded
    down to a multiple of 8 so every chunk boundary falls on a bitmap-mask
    byte boundary — chunked bitmap bytes sum EXACTLY to the unsplit
    leaf's (``ceil(n/8)`` per chunk loses nothing when n % 8 == 0).
    A pure function of (itemsize, threshold): per-leaf or per-topology
    inputs here would break the cross-``n_shards`` byte invariance.

    ``split_bytes`` is clamped up to ``_MIN_CHUNK_BYTES`` (one-time
    warning): below that the chunk count grows without bound while each
    chunk's meta overhead stays fixed, so a tiny threshold silently
    explodes a large leaf into thousands of subkeys."""
    global _warned_small_split
    if 0 < split_bytes < _MIN_CHUNK_BYTES:
        if not _warned_small_split:
            _warned_small_split = True
            warnings.warn(
                f"shard_split_bytes={split_bytes} is below the "
                f"{_MIN_CHUNK_BYTES}-byte chunk floor; clamping — a "
                "smaller threshold only multiplies per-chunk meta "
                "overhead without improving balance",
                stacklevel=2,
            )
        split_bytes = _MIN_CHUNK_BYTES
    return max((split_bytes // max(itemsize, 1)) // 8 * 8, 8)


def iter_subleaves(
    key: str, leaf: Any, split_bytes: int
) -> Iterator[tuple[str, int, int]]:
    """Yield ``(subkey, offset_elems, n_elems)`` chunks of one leaf.

    A pure function of (leaf template, split_bytes) — never of the shard
    count — so the chunking, and with it every wire byte, is identical
    across topologies.  Unsplit leaves yield themselves with
    ``subkey == key``.
    """
    n, itemsize = _size_itemsize(leaf)
    nbytes = n * itemsize
    if split_bytes <= 0 or nbytes <= split_bytes:
        yield key, 0, n
        return
    step = chunk_elems(itemsize, split_bytes)
    for i, off in enumerate(range(0, n, step)):
        yield f"{key}#{i:04d}", off, min(step, n - off)


def _size_itemsize(leaf: Any) -> tuple[int, int]:
    """(elements, bytes per element) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel(), leaf.element_size()
    a = np.asarray(leaf)
    return int(a.size), a.dtype.itemsize


def _flat(leaf: Any):
    """A flat view of a tensor (on its device) or array leaf."""
    if isinstance(leaf, torch.Tensor):
        return leaf.contiguous().view(-1)
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1)


def job_namespace(job_id: Optional[str]) -> str:
    """The per-job leaf-key prefix of the multi-job control plane
    (DESIGN.md §14): ``'j<id>/'`` for a fleet job, ``''`` for a solo job —
    the empty prefix keeps the single-job wire metadata byte-identical.
    ``'/'`` cannot occur in a job id (ids are validated by the scheduler)
    and terminates the prefix, so two distinct jobs can never collide on a
    key and a prefixed key can never equal an unprefixed one."""
    if job_id is None or job_id == "":
        return ""
    jid = str(job_id)
    if "/" in jid or "#" in jid:
        raise ValueError(f"job id must not contain '/' or '#': {jid!r}")
    return f"j{jid}/"


def tree_assignment(
    tree: PyTree,
    n_shards: int,
    split_bytes: int = 0,
    namespace: str = "",
    partitioner: str = "greedy",
) -> dict[str, int]:
    """The canonical assignment for a parameter template: keys are the
    checkpoint-store path keys (``wire.codec.tree_keys``) — or their
    ``key#chunk`` subkeys when ``split_bytes`` carves oversized leaves —
    weights the dense bytes, the quantity the balance bound is stated in.

    With a ``namespace`` (``job_namespace(job_id)``, multi-job control
    plane) every key is prefixed before placement.  Because the prefix is
    uniform across one job's keys, the (size desc, key asc) placement
    order — and therefore the partition itself — is IDENTICAL to the
    unprefixed one: a job sharded inside a fleet owns exactly the
    slices-per-shard it owns solo (property-tested in
    ``tests/test_runtime_multijob.py``).

    ``partitioner`` selects the placement policy: ``"greedy"`` (the
    default — least-loaded, best static balance, but a shard-count
    change can reshuffle everything) or ``"ring"`` (consistent hashing,
    minimal key movement across shard-count changes — the live-reshard
    partitioner).  Greedy stays the default so every existing run is
    bit-identical.

    Warns when any shard ends up owning ZERO bytes: every update round
    still pays that shard a round trip for nothing, and a sweep over
    shard counts silently stops measuring anything past that point.
    """
    keys = wire_codec.tree_keys(tree)
    leaves = tree_lib.leaves(tree)
    subkeys: list[str] = []
    sizes: list[int] = []
    for key, leaf in zip(keys, leaves):
        itemsize = _size_itemsize(leaf)[1]
        for subkey, _off, n in iter_subleaves(key, leaf, split_bytes):
            subkeys.append(namespace + subkey)
            sizes.append(n * itemsize)
    if partitioner == "greedy":
        assignment = assign_shards(subkeys, sizes, n_shards)
    elif partitioner == "ring":
        assignment = ring_assign(subkeys, n_shards)
    else:
        raise ValueError(
            f"unknown partitioner {partitioner!r} (greedy|ring)"
        )
    load = [0] * n_shards
    for subkey, size in zip(subkeys, sizes):
        load[assignment[subkey]] += size
    empty = [s for s, b in enumerate(load) if b == 0]
    if empty:
        warnings.warn(
            f"shard(s) {empty} own zero update bytes: the tree has only "
            f"{len(subkeys)} assignable leaves/chunks for {n_shards} "
            "shards — split oversized leaves (shard_split_bytes) or use "
            "a leafier workload",
            stacklevel=2,
        )
    return assignment


def tree_subleaves(
    tree: PyTree, split_bytes: int, namespace: str = ""
) -> list[tuple[str, str, int, int]]:
    """Flat list of ``(leaf_key, namespaced_subkey, offset_elems,
    n_elems)`` for every chunk of every leaf — the key universe a live
    handover enumerates when computing which stored identities move
    between shards (``leaf_key`` here is the namespaced key the metas
    carry in ``m['k']``)."""
    keys = wire_codec.tree_keys(tree)
    leaves = tree_lib.leaves(tree)
    out: list[tuple[str, str, int, int]] = []
    for key, leaf in zip(keys, leaves):
        for subkey, off, n in iter_subleaves(key, leaf, split_bytes):
            out.append((namespace + key, namespace + subkey, off, n))
    return out


def offset_owner(
    tree: PyTree,
    split_bytes: int,
    assignment: dict[str, int],
    namespace: str = "",
) -> Callable[[str, int], int]:
    """Owner lookup ``(namespaced_leaf_key, offset_elems) -> shard`` under
    ``assignment`` (a ``tree_assignment`` for the SAME split_bytes).

    This is how a handover maps stored entries — chunked at the *old*
    ``split_bytes`` — onto the *new* topology when the thresholds differ:
    each old chunk goes to whichever new shard owns the new chunk that
    contains the old chunk's start offset.  Totality (each element
    stored exactly once across shards) is preserved, which is the only
    invariant pre-fence data needs — post-fence pulls never read
    pre-fence steps, and dump reassembly is order-insensitive per
    (worker, step)."""
    starts: dict[str, tuple[list[int], list[int]]] = {}
    for leaf_key, subkey, off, _n in tree_subleaves(
        tree, split_bytes, namespace
    ):
        offs, shards = starts.setdefault(leaf_key, ([], []))
        offs.append(off)
        shards.append(assignment[subkey])

    def owner(leaf_key: str, off: int) -> int:
        offs, shards = starts[leaf_key]
        return shards[bisect.bisect_right(offs, int(off)) - 1]

    return owner


def encode_tree_sharded(
    tree: PyTree,
    assignment: dict[str, int],
    n_shards: int,
    scheme: str = wire_codec.AUTO,
    quant: str = "none",
    with_residual: bool = False,
    split_bytes: int = 0,
    namespace: str = "",
    impl: str = "numpy",
) -> tuple[list[tuple[list[dict], list]], Optional[PyTree]]:
    """Encode a pytree into one (meta, buffer-views) message per shard.

    Leaves (and, under ``split_bytes``, their chunks in ascending offset
    order) keep the global ``tree_keys`` order *within* each shard, so a
    peer decoding shard by shard reassembles every element in a fixed
    order regardless of ``n_shards`` — the bit-exactness across shard
    counts rests on this.  Chunk metas carry the full leaf key in ``k``
    plus the flat element offset in ``o``; ``LeafBuffers`` is the decode
    twin.  Under a job ``namespace`` the meta keys and the assignment
    lookups are both prefixed — a fleet worker's ``LeafBuffers`` is keyed
    by the same prefixed keys, so one job can never decode into another
    job's accumulators.  Returns ``(per_shard, residual_tree)`` where
    ``per_shard[s]`` feeds ``publish``/``flush`` to shard ``s`` directly.
    ``impl`` selects the codec implementation per leaf (numpy reference
    or the fused CUDA wire-pack kernel) — wire bytes,
    metas and residuals are bit-identical either way.
    """
    keys = wire_codec.tree_keys(tree)
    leaves = tree_lib.leaves(tree)
    per_shard: list[tuple[list[dict], list]] = [
        ([], []) for _ in range(n_shards)
    ]
    residuals: list = []
    for key, leaf in zip(keys, leaves):
        flat = _flat(leaf)
        res_flat = None
        for subkey, off, n in iter_subleaves(key, leaf, split_bytes):
            m, parts, r = wire_codec.encode_leaf(
                flat[off: off + n] if subkey != key else leaf,
                scheme=scheme, quant=quant, key=namespace + key,
                with_residual=with_residual, impl=impl,
            )
            if subkey != key:
                m["o"] = off
            meta_s, parts_s = per_shard[assignment[namespace + subkey]]
            meta_s.append(m)
            parts_s.extend(parts)
            if with_residual:
                if subkey == key:
                    res_flat = r.reshape(-1)
                else:
                    if res_flat is None:
                        res_flat = (
                            torch.zeros(flat.numel(), dtype=torch.float32,
                                        device=flat.device)
                            if isinstance(flat, torch.Tensor)
                            else np.zeros(flat.size, np.float32))
                    res_flat[off: off + n] = r
        residuals.append(
            res_flat.reshape(tuple(leaf.shape))
            if res_flat is not None else None
        )
    res_tree = tree_lib.unflatten(tree, residuals) if with_residual else None
    return per_shard, res_tree


def predict_shard_nbytes(
    tree: PyTree,
    assignment: dict[str, int],
    n_shards: int,
    scheme: str = wire_codec.AUTO,
    quant: str = "none",
    split_bytes: int = 0,
    namespace: str = "",
) -> list[int]:
    """Simulator-side per-shard accounting: wire bytes each shard WOULD
    measure for this tree — the per-leaf accountant is the codec's own
    ``predict_leaf_nbytes`` (same ``leaf_nbytes`` formula + ``auto``
    resolution the encoder asserts against), chunked and bucketed by the
    same assignment the encoder uses, so ``== broker-measured`` per shard
    by construction."""
    keys = wire_codec.tree_keys(tree)
    out = [0] * n_shards
    for key, leaf in zip(keys, tree_lib.leaves(tree)):
        flat = _flat(leaf)
        for subkey, off, n in iter_subleaves(key, leaf, split_bytes):
            out[assignment[namespace + subkey]] += wire_codec.predict_leaf_nbytes(
                flat[off: off + n] if subkey != key else leaf,
                scheme, quant,
            )
    return out


class LeafBuffers:
    """Per-leaf-key accumulation buffers on the device — the ONE
    decode-side assembler for sharded (and possibly split) update payloads.

    ``add`` folds a decoded leaf or chunk into its buffer at the chunk's
    flat offset, in arrival order: within a shard that is ascending
    worker then ascending ``tree_keys``/offset order, and every element
    is owned by exactly one shard — the fixed per-element float32
    summation order the cross-topology bit-exactness claim rests on.
    Flush reassembly uses the same ``add`` (chunks of one worker's flush
    are disjoint, so summing into zeros reproduces the exact values).
    """

    def __init__(self, leaf_like: dict[str, tuple[Any, Any]],
                 device: Any = "cpu"):
        self._bufs = {
            k: torch.zeros(tuple(shape), dtype=dtype, device=device)
            for k, (shape, dtype) in leaf_like.items()
        }
        self._added = {k: 0 for k in self._bufs}

    def add(self, meta: dict, decoded: Any) -> None:
        buf = self._bufs[meta["k"]].view(-1)
        arr = decoded if isinstance(decoded, torch.Tensor) else (
            wire_codec.to_tensor(np.asarray(decoded), buf.device))
        arr = arr.reshape(-1)
        off = int(meta.get("o", 0))
        buf[off: off + arr.numel()] += arr
        self._added[meta["k"]] += arr.numel()

    def add_encoded(self, meta: dict, blob, impl: str = "numpy") -> None:
        """Fold one ENCODED leaf/chunk straight into its buffer slice.
        Under ``impl='cuda'``/'auto' a bitmap part goes through the fused
        unpack-apply kernel (B5) on the buffer's device, so only the wire
        bytes cross to it; every other case is exactly
        ``add(meta, decode_leaf(meta, blob))``. Bit-identical across impls
        (the kernel's off-support lanes add the same +0.0)."""
        if impl == "numpy":
            self.add(meta, wire_codec.decode_leaf(meta, blob))
            return
        buf = self._bufs[meta["k"]].view(-1)
        n = int(np.prod(meta["shape"])) if meta["shape"] else 1
        off = int(meta.get("o", 0))
        buf[off: off + n] = wire_codec.decode_add_leaf(
            buf[off: off + n], meta, blob, impl=impl
        )
        self._added[meta["k"]] += n

    def assert_complete(self, copies: int = 1, what: str = "tree") -> None:
        """Every element must have arrived exactly ``copies`` times — the
        all-or-nothing witness for flush/dump reassembly."""
        bad = {
            k: (got, self._bufs[k].numel() * copies)
            for k, got in self._added.items()
            if got != self._bufs[k].numel() * copies
        }
        if bad:
            raise ValueError(
                f"incomplete {what} reassembly: got/expected elements "
                f"per leaf {bad}"
            )

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._bufs[key]

    def __contains__(self, key: str) -> bool:
        return key in self._bufs


def iter_part_views(descs: list[dict], payload):
    """Walk one shard's multi-part pull/dump payload: yields
    ``(desc, leaf_meta, byte_view)`` for every leaf of every part — the
    ONE place the per-part offset bookkeeping lives.  ``iter_part_leaves``
    decodes on top of this; the worker's fused decode/apply path hands
    the views to ``LeafBuffers.add_encoded`` instead."""
    from repro_torch.wire.framing import unpack_parts

    for desc, part in unpack_parts(descs, payload):
        view = memoryview(part)
        off = 0
        for m in desc["meta"]:
            nb = int(m["nbytes"])
            yield desc, m, view[off:off + nb]
            off += nb
        if off != len(view):
            raise ValueError(
                f"part for worker {desc.get('worker')}: {len(view) - off} "
                "trailing bytes after its leaf metas"
            )


def iter_part_leaves(descs: list[dict], payload, impl: str = "numpy"):
    """Walk one shard's multi-part pull/dump payload: yields
    ``(desc, leaf_meta, decoded_leaf)`` for every leaf of every part.

    The ONE decode twin of ``encode_tree_sharded``'s slicing — the
    worker's peer-sum/flush reassembly and the supervisor's dump merge
    both consume this, so the offset bookkeeping and key-order
    assumptions the bit-exactness claim rests on live in one place.
    """
    for desc, m, view in iter_part_views(descs, payload):
        yield desc, m, wire_codec.decode_leaf(m, view, impl=impl)


def shard_bytes_bound(
    sizes: Sequence[int], n_shards: int
) -> float:
    """The list-scheduling balance bound the property tests assert:
    ``max shard load <= total/n + max item`` for least-loaded placement."""
    total = float(sum(sizes))
    biggest = float(max(sizes, default=0))
    return total / max(n_shards, 1) + biggest
