"""Serving state stores: segment-granular prefix caching and session resume.

In an RMT the recurrent memory at a segment boundary (every layer's ARMT
A and z, or Mamba's h and conv tail) is a constant-size summary of the
whole prefix. So a prefix can be cached at segment granularity by keeping
that state per boundary, where a KV-cache prefix store keeps every token's
keys and values, and a conversation can resume by feeding only its new
turn.

* ``SegmentSnapshot``: the state at a boundary (its recurrent leaves), the
  exact token prefix it summarizes, and the boundary's last-position
  logits, so an exact full-prefix hit needs no forward at all. At a
  boundary the in-segment position is 0 and the segment's KV cache empty,
  so neither is stored.
* ``PrefixCache``: content-addressed by a rolling hash over the segments'
  token ids, digest(c) = H(digest(c - 1) || tokens of segment c), so every
  boundary key of a P-token prompt costs one O(P) pass. A match walks the
  boundaries longest first and verifies a candidate's full token ids before
  returning it: a hash collision counts and falls through.
* ``SessionStore``: the full decode state at the end of a generation (the
  recurrent memory, the current segment's KV cache; in cache mode the
  whole KV cache) keyed by ``session_id``, with its position, the tokens
  emitted but not yet fed (``pending``) and the token history. The next
  turn resumes from it, feeding only ``pending`` and its new prompt.

Both stores keep their entries in one LRU under a byte budget. An evicted
payload spills to disk as a named blob (``checkpoint/manager.py``) when a
spill directory is given and comes back, to the device it was stored from,
on its next use; without one, an evicted prefix is a future miss, and an
evicted session leaves a tombstone: resuming it raises ``SessionEvicted``
rather than serving a turn that has forgotten the conversation.

Payloads are trees (dicts and tuples) of tensors on the engine's device;
the store keeps what it is given, so the caller hands it tensors of its
own (copies). Byte counts come from shapes and dtypes, with no device
read. A payload crosses to the host only when it spills.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["SegmentSnapshot", "SessionEntry", "SessionEvicted", "StoreStats",
           "PrefixCache", "SessionStore", "prefix_hash_chain", "tree_nbytes"]


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _spec(tree, counter):
    """The tree with each leaf replaced by its index in ``_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _spec(v, counter) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_spec(v, counter) for v in tree)
    counter[0] += 1
    return counter[0] - 1


def _unflatten(spec, leaves):
    if isinstance(spec, dict):
        return {k: _unflatten(v, leaves) for k, v in spec.items()}
    if isinstance(spec, tuple):
        return tuple(_unflatten(v, leaves) for v in spec)
    return leaves[spec]


def tree_nbytes(tree: Any) -> int:
    """Bytes of the tensor leaves of a tree, from shapes and dtypes only
    (other leaves, such as a host int position, count nothing)."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if isinstance(t, torch.Tensor))


def prefix_hash_chain(tokens, seg_len: int) -> List[bytes]:
    """Rolling hash over segment token ids: entry c - 1 keys the boundary
    after c whole segments. digest(c) = blake2b(digest(c - 1) || segment c
    as int32 bytes), from the seed b"rmt-prefix-v1": the reference's keys,
    byte for byte."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    if toks.ndim != 1:
        raise ValueError(f"tokens must be 1-D, got shape {toks.shape}")
    out: List[bytes] = []
    h = b"rmt-prefix-v1"
    for c in range(toks.shape[0] // seg_len):
        seg = toks[c * seg_len:(c + 1) * seg_len]
        h = hashlib.blake2b(h + seg.tobytes(), digest_size=16).digest()
        out.append(h)
    return out


@dataclass
class SegmentSnapshot:
    """Recurrent state at a segment boundary (pos 0, segment cache empty)."""
    tokens: np.ndarray        # int32 [c * seg_len]: the exact prefix
    state: Any                # {'prelude', 'pattern'} recurrent leaves, B = 1
    logits: torch.Tensor      # [1, V] fp32 logits at the boundary
    n_segments: int
    nbytes: int


@dataclass
class SessionEntry:
    """The stored end-of-generation state of one conversation."""
    tokens: np.ndarray        # int32: the whole consumed history (prompts and outputs)
    state: Any                # {'prelude', 'pattern'} decode leaves, B = 1
    pos: int                  # the state's in-segment position (cache mode: tokens cached)
    pending: np.ndarray       # int32: emitted, not yet fed; fed before the next prompt
    nbytes: int = 0


class SessionEvicted(KeyError):
    """The session's state was evicted under the byte budget with no disk
    spill: it cannot be resumed exactly."""


@dataclass
class _Slot:
    payload: Any              # tree of tensors; None while spilled
    meta: Dict[str, Any]      # host metadata (tokens, pos, ...)
    nbytes: int
    spilled: bool = False
    spec: Any = None          # while spilled: the tree's structure
    devices: Any = None       # while spilled: each leaf's device


@dataclass
class StoreStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    spills: int = 0
    restores: int = 0
    collisions: int = 0
    bytes_in_ram: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(vars(self))


class _ByteLRU:
    """An LRU of payloads keyed by strings or bytes, over a byte budget:
    entries beyond it are evicted oldest first, spilled to named blobs when
    a spill is given, else dropped (with a tombstone, if asked)."""

    def __init__(self, max_bytes: int, *, spill=None, spill_dir=None,
                 namespace: str = "blob", tombstone_on_drop: bool = False):
        if spill is None and spill_dir is not None:
            from repro_torch.checkpoint.manager import CheckpointManager
            spill = CheckpointManager(spill_dir)
        self.max_bytes = int(max_bytes)
        self.spill = spill
        self.namespace = namespace
        self.tombstone_on_drop = tombstone_on_drop
        self.entries: "OrderedDict[Any, _Slot]" = OrderedDict()
        self.tombstones: set = set()
        self.stats = StoreStats()

    def _spill_name(self, key) -> str:
        k = key.hex() if isinstance(key, bytes) else str(key)
        return f"{self.namespace}/{k}"

    def _evict_to_budget(self) -> None:
        while self.stats.bytes_in_ram > self.max_bytes:
            victim = next((k for k, s in self.entries.items() if s.payload is not None), None)
            if victim is None:
                return
            slot = self.entries[victim]
            self.stats.bytes_in_ram -= slot.nbytes
            self.stats.evictions += 1
            if self.spill is not None:
                leaves = _leaves(slot.payload)
                self.spill.save_named(self._spill_name(victim),
                                      {str(i): t for i, t in enumerate(leaves)})
                slot.spec = _spec(slot.payload, [0])
                slot.devices = [t.device for t in leaves]
                slot.payload, slot.spilled = None, True
                self.stats.spills += 1
            else:
                del self.entries[victim]
                if self.tombstone_on_drop:
                    self.tombstones.add(victim)

    def put(self, key, payload: Any, meta: Dict[str, Any]) -> None:
        old = self.entries.pop(key, None)
        if old is not None and old.payload is not None:
            self.stats.bytes_in_ram -= old.nbytes
        self.tombstones.discard(key)
        nbytes = tree_nbytes(payload)
        self.entries[key] = _Slot(payload=payload, meta=meta, nbytes=nbytes)
        self.stats.bytes_in_ram += nbytes
        self.stats.insertions += 1
        self._evict_to_budget()

    def get(self, key) -> Optional[_Slot]:
        """The slot with its payload resident (restored from disk, to the
        devices it was stored from, if it was spilled), or None if unknown.
        The owner checks ``is_tombstoned`` first."""
        slot = self.entries.get(key)
        if slot is None:
            return None
        if slot.payload is None and slot.spilled:
            blob = self.spill.restore_named(self._spill_name(key))
            leaves = [t.to(d) for t, d in zip(blob.values(), slot.devices)]
            slot.payload = _unflatten(slot.spec, leaves)
            slot.spilled, slot.spec, slot.devices = False, None, None
            self.stats.bytes_in_ram += slot.nbytes
            self.stats.restores += 1
            # a burst of restores must not hold more than the budget: the
            # restored entry is made most recent, then the store re-evicts.
            # If it alone exceeds the budget it spills straight back, and
            # the caller gets a transient slot holding the payload
            self.entries.move_to_end(key)
            payload = slot.payload
            self._evict_to_budget()
            if slot.payload is None:
                return _Slot(payload=payload, meta=slot.meta, nbytes=slot.nbytes)
        self.entries.move_to_end(key)
        return slot

    def is_tombstoned(self, key) -> bool:
        return key in self.tombstones

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key) -> bool:
        return key in self.entries


class PrefixCache:
    """Content-addressed cache of segment-boundary snapshots, keyed by
    ``prefix_hash_chain``. A match walks a prompt's boundaries longest first
    and verifies the candidate's full token ids before returning it: a
    colliding key must never transplant another context's memory."""

    def __init__(self, seg_len: int, *, max_bytes: int = 256 << 20, spill_dir=None,
                 spill=None):
        if seg_len < 1:
            raise ValueError(f"seg_len must be >= 1, got {seg_len}")
        self.seg_len = seg_len
        self._lru = _ByteLRU(max_bytes, spill=spill, spill_dir=spill_dir,
                             namespace="prefix", tombstone_on_drop=False)

    @property
    def stats(self) -> StoreStats:
        return self._lru.stats

    def __len__(self) -> int:
        return len(self._lru)

    def match(self, tokens, *, chain: Optional[List[bytes]] = None
              ) -> Tuple[int, Optional[SegmentSnapshot]]:
        """The longest cached prefix of ``tokens`` at segment granularity:
        (cached segments, snapshot), or (0, None) on a miss. chain: this
        prompt's ``prefix_hash_chain``, when the caller has it already."""
        tokens = np.asarray(tokens, np.int32)
        if chain is None:
            chain = prefix_hash_chain(tokens, self.seg_len)
        for c in range(len(chain), 0, -1):
            key = chain[c - 1]
            slot = self._lru.entries.get(key)
            if slot is None:
                continue
            if not np.array_equal(slot.meta["tokens"], tokens[:c * self.seg_len]):
                self._lru.stats.collisions += 1
                continue
            slot = self._lru.get(key)            # restore if spilled, touch the LRU
            self._lru.stats.hits += 1
            return c, SegmentSnapshot(tokens=slot.meta["tokens"],
                                      state=slot.payload["state"],
                                      logits=slot.payload["logits"], n_segments=c,
                                      nbytes=slot.nbytes)
        self._lru.stats.misses += 1
        return 0, None

    def insert(self, tokens, state: Any, logits: torch.Tensor, *,
               key: Optional[bytes] = None) -> bool:
        """Cache the snapshot of the whole-segment prefix ``tokens``. False
        when that prefix is cached already (its recency is refreshed). key:
        the prefix's digest, when the caller has the chain already (one
        O(P) pass per admission, not one per boundary)."""
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        if tokens.ndim != 1 or tokens.shape[0] % self.seg_len:
            raise ValueError(f"a prefix of whole segments of {self.seg_len} tokens, got "
                             f"shape {tokens.shape}")
        if key is None:
            key = prefix_hash_chain(tokens, self.seg_len)[-1]
        slot = self._lru.entries.get(key)
        if slot is not None and np.array_equal(slot.meta["tokens"], tokens):
            self._lru.entries.move_to_end(key)
            return False
        self._lru.put(key, {"state": state, "logits": logits}, {"tokens": tokens})
        return True


class SessionStore:
    """End-of-generation decode states keyed by session_id. ``get`` returns
    None for a session never seen (a first turn) and raises SessionEvicted
    for one dropped under the byte budget without a spill: a lost session
    must not silently restart with no memory of the conversation."""

    def __init__(self, *, max_bytes: int = 512 << 20, spill_dir=None, spill=None):
        self._lru = _ByteLRU(max_bytes, spill=spill, spill_dir=spill_dir,
                             namespace="session", tombstone_on_drop=True)

    @property
    def stats(self) -> StoreStats:
        return self._lru.stats

    def __len__(self) -> int:
        return len(self._lru)

    def __contains__(self, session_id: str) -> bool:
        return session_id in self._lru

    def get(self, session_id: str) -> Optional[SessionEntry]:
        if self._lru.is_tombstoned(session_id):
            raise SessionEvicted(
                f"session {session_id!r} was evicted under the byte budget (no spill "
                "dir configured); it cannot be resumed exactly")
        slot = self._lru.get(session_id)
        if slot is None:
            self._lru.stats.misses += 1
            return None
        self._lru.stats.hits += 1
        return SessionEntry(tokens=slot.meta["tokens"], state=slot.payload,
                            pos=slot.meta["pos"], pending=slot.meta["pending"],
                            nbytes=slot.nbytes)

    def put(self, session_id: str, *, state: Any, pos: int, pending, tokens) -> None:
        self._lru.put(session_id, state,
                      {"tokens": np.asarray(tokens, np.int32), "pos": int(pos),
                       "pending": np.asarray(pending, np.int32)})

    def delete(self, session_id: str) -> None:
        slot = self._lru.entries.pop(session_id, None)
        if slot is not None and slot.payload is not None:
            self._lru.stats.bytes_in_ram -= slot.nbytes
        self._lru.tombstones.discard(session_id)
