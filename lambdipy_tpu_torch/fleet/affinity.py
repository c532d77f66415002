"""Prefix-affinity keys and replica selection for the fleet router.

The port's copy of ``lambdipy_tpu/fleet/affinity.py``: the same key bytes
and the same rendezvous picks, so a JAX router and the port's send a
request to the same replica name.

The radix prefix cache (runtime/prefixstore.py) is per-replica: spraying
shared-prefix traffic round-robin across N replicas dilutes every
replica's hit rate to ~1/N of what one process would see. The router
instead hashes each request's LEADING TOKEN BLOCKS — the same fixed
block width the radix tree is keyed by — so all prompts that would
longest-prefix-match each other land on the replica that already holds
their KV.

Two pieces:

- :func:`prefix_key` turns a request body (internal ``/invoke`` shape or
  OpenAI ``/v1/completions`` shape) into a stable bytes key over the
  prompt's leading whole blocks. Prompts shorter than one block key on
  the whole prompt (the radix store cannot cache them, but identical
  short prompts still co-locate); string prompts key on a leading
  character window sized ~4 chars/token so tokenizer-equal prefixes
  agree without tokenizing in the router.
- :func:`pick_replica` is RENDEZVOUS (highest-random-weight) hashing:
  each (key, replica) pair scores independently, so ejecting or draining
  one replica remaps ONLY the keys that were on it — the rest of the
  fleet keeps its warm caches. A plain modulo ring would reshuffle
  nearly every key on any membership change.
"""

from __future__ import annotations

import hashlib
import json

# keep in sync with runtime/prefixstore.py PrefixStore's default block;
# the router's --block flag overrides it to match non-default bundles
DEFAULT_BLOCK = 32

# the key window: only the FIRST key_blocks whole blocks feed the hash.
# Keying on every whole block would give prompts that share a long
# prefix but differ in later blocks (512-token system prompt + distinct
# 100-token user turns) different keys — scattering exactly the traffic
# affinity exists to co-locate. Eight 32-token blocks ≈ a system-prompt
# of shared context; suffix divergence past it cannot split the key.
DEFAULT_KEY_BLOCKS = 8

# string prompts: ~4 characters per BPE token is the usual planning
# number; exactness is irrelevant — both sides of a shared prefix just
# need to produce the SAME key
CHARS_PER_TOKEN = 4


def _flat_int_row(val) -> list | None:
    """First flat int row of a tokens/prompt field, else None."""
    if isinstance(val, (list, tuple)) and val:
        if isinstance(val[0], (list, tuple)):  # batched rows: key on row 0
            val = val[0]
        if isinstance(val, (list, tuple)) and val and \
                all(isinstance(t, int) for t in val):
            return list(val)
    return None


def prefix_key(request: dict, *, block: int = DEFAULT_BLOCK,
               key_blocks: int = DEFAULT_KEY_BLOCKS) -> bytes | None:
    """Stable affinity key from a request's prompt prefix — the leading
    ``min(whole blocks, key_blocks)`` token blocks — or None when the
    body carries nothing routable (the router then falls back to
    least-outstanding)."""
    if not isinstance(request, dict):
        return None
    block = max(1, int(block))
    key_blocks = max(1, int(key_blocks))
    # client-supplied explicit prefix is part of the effective prompt:
    # requests sharing it must co-locate with requests that inline it
    head: list = []
    pref = _flat_int_row(request.get("prefix"))
    if pref:
        # bounded like every other key ingredient: divergence past the
        # key window must not split keys (or bloat them)
        head.extend(pref[: key_blocks * block])
    toks = _flat_int_row(request.get("tokens"))
    if toks is None:
        toks = _flat_int_row(request.get("prompt"))
    if toks is not None:
        seq = head + toks
        n = min(len(seq) // block, key_blocks) * block
        return json.dumps(seq[:n] if n else seq).encode()
    text = request.get("text")
    if text is None and isinstance(request.get("prompt"), str):
        text = request["prompt"]
    if isinstance(text, str) and text:
        n_chars = block * CHARS_PER_TOKEN
        n = min(len(text) // n_chars, key_blocks) * n_chars
        if head:
            # an explicit token prefix IS the reusable KV: requests
            # sharing it must co-locate even with string suffixes, so
            # the key is the prefix plus the text's WHOLE char-blocks
            # (possibly none — short differing suffixes collapse)
            return json.dumps(head).encode() + b"|" + text[:n].encode()
        return text[: n if n else len(text)].encode()
    if head:
        # prefix-only request: same key shape as prefix + sub-block
        # text, so it co-locates with those too
        return json.dumps(head).encode() + b"|"
    return None


def warm_prompt(request: dict, *, block: int = DEFAULT_BLOCK,
                key_blocks: int = DEFAULT_KEY_BLOCKS):
    """The request's leading whole-block prompt head as a REPLAYABLE
    prompt (token list or string) — what an affinity-aware cache warm
    should prefill on a fresh replica so the radix store holds the
    fleet's hot prefixes again. None when the prompt has no whole block
    (nothing the radix store could cache) or when the shape cannot be
    replayed standalone (mixed explicit-prefix + string suffix)."""
    if not isinstance(request, dict):
        return None
    block = max(1, int(block))
    key_blocks = max(1, int(key_blocks))
    head: list = []
    pref = _flat_int_row(request.get("prefix"))
    if pref:
        head.extend(pref[: key_blocks * block])
    toks = _flat_int_row(request.get("tokens"))
    if toks is None:
        toks = _flat_int_row(request.get("prompt"))
    if toks is not None:
        seq = head + toks
        n = min(len(seq) // block, key_blocks) * block
        return seq[:n] if n else None
    text = request.get("text")
    if text is None and isinstance(request.get("prompt"), str):
        text = request["prompt"]
    if isinstance(text, str) and text and not head:
        n_chars = block * CHARS_PER_TOKEN
        n = min(len(text) // n_chars, key_blocks) * n_chars
        return text[:n] if n else None
    if head:
        n = min(len(head) // block, key_blocks) * block
        return head[:n] if n else None
    return None


# the phase-split ship moves KV, not affinity: the 8-block affinity
# window is sized for rendezvous key stability, but a ship clipped to
# it would leave every token past block 8 as a local re-prefill on the
# decode replica — exactly the work the prefill class exists to absorb,
# and (pipelined) exactly the transfer the chunk stream hides under the
# prefill. 64 blocks (2-4k tokens at the default widths) covers the
# window-clamped head of everything this stack serves; the export leg
# clamps to the replica's window server-side either way. The ship-dedup
# key stays the 8-block affinity key — two prompts sharing the window
# but diverging later hit the dedup entry, and the import-miss PROBE
# (which checks the full head) pulls the divergent tail back.
SHIP_KEY_BLOCKS = 64


def ship_prompt(request: dict, *, block: int = DEFAULT_BLOCK,
                key_blocks: int = DEFAULT_KEY_BLOCKS) -> list | None:
    """:func:`warm_prompt` restricted to TOKEN heads — what the
    disaggregated router can actually SHIP: the KV wire frame names
    token ids and the router never tokenizes, so a string head (which
    warm_prompt happily replays as a warm request) cannot key an
    export. None = serve mixed-mode, no ship."""
    head = warm_prompt(request, block=block, key_blocks=key_blocks)
    return head if isinstance(head, list) else None


# sessions re-ship their whole conversation head on failover, so the
# session head is far wider than the affinity key window — but BOUNDED:
# the router keeps one head per live session, and an unbounded head
# would grow router memory with context length. 256 blocks (8-16k
# tokens at the default widths) covers every context window this stack
# serves; a longer conversation's tail simply re-prefills on the new
# home after a failover — the documented degraded path, never a loss.
# (The export leg also clamps to the replica's window server-side.)
SESSION_KEY_BLOCKS = 256


def session_key(session_id) -> bytes:
    """Rendezvous key for session FAILOVER re-targeting: where an open
    session lands when its home replica dies or drains. Deliberately
    namespaced away from prefix keys (two sessions sharing a system
    prompt should spread on failover, not pile onto one survivor).

    NOT for first-turn/unknown-session placement: a session id the
    router has never seen (first turn, or any turn after a router
    restart) must fall back to NORMAL prefix affinity over the request
    body — hashing the bare session id would scatter the first
    post-restart turn away from the replica whose radix cache already
    holds the conversation from before the restart."""
    return b"sess\x00" + str(session_id).encode()


def pick_replica(key: bytes, names) -> str | None:
    """Rendezvous-hash ``key`` onto one of ``names`` (any iterable of
    replica names). Deterministic; removing a name never remaps keys
    held by the others."""
    best_name, best_score = None, b""
    for name in names:
        score = hashlib.blake2b(key + b"\x00" + str(name).encode(),
                                digest_size=8).digest()
        if best_name is None or score > best_score:
            best_name, best_score = name, score
    return best_name
