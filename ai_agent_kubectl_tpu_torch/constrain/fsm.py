"""Token-level FSM: the byte DFA compiled against a tokenizer.

SGLang's compressed-FSM technique: the grammar is enforced
per *token*, not per byte — each decode step needs (a) the set of token
ids legal from the current state (the sampling mask) and (b) the state
the sampled token leads to. Materializing a dense ``[n_states, vocab]``
transition table on device would be ~100 MB at a 256k vocab, so the
compile collapses the token axis to *equivalence classes*: two tokens
share a class iff they induce the same state→state map (identical
columns of the dest matrix). Real grammars compress 256k tokens into a
few hundred classes, so the device carries

- ``tok_class``  [vocab]            int32 — token → class,
- ``class_next`` [n_states, n_cls]  int32 — state × class → state,
- ``class_ok``   [n_states, n_cls]  bool  — legal from this state
  (next != DEAD; the EOS class is legal exactly in accept states),

a few hundred KB total, gathered per decode step inside the decode
chunk (engine/batcher.py).

Forced runs are precomputed host-side: a state with exactly ONE legal
token id starts a forced chain the scheduler can splice in a single
suffix prefill instead of decoding token-by-token (the fast-forward
tentpole). ``forced_tok[s]`` is that token id (-1 otherwise);
``forced_eos[s]`` marks accept states whose only legal token is EOS.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..engine.tokenizer import ByteTokenizer, Tokenizer
from .grammar import DEAD, START, CharDFA


def token_byte_table(tokenizer: Tokenizer,
                     vocab_size: int) -> List[Optional[bytes]]:
    """UTF-8 byte string of every token id, or None for ids the FSM must
    never emit: specials (EOS is handled as its own class by the
    compiler), ids past the tokenizer's vocab (toy models over-allocate
    the embedding table), empty renderings (zero-progress tokens would
    let the FSM stall forever), and tokens whose solo decode is lossy
    (U+FFFD — byte-fallback fragments; conservative: a multi-byte
    character the grammar wants can still arrive via its whole-character
    tokens).

    For :class:`ByteTokenizer` the mapping is exact by construction.
    For HF tokenizers this is the decode-based view; left-strip
    position dependence (SentencePiece ``▁``) makes it approximate for
    leading-space pieces — acceptable for masking (conservative), noted
    here so nobody mistakes it for a round-trip guarantee.
    """
    out: List[Optional[bytes]] = [None] * vocab_size
    specials = set(getattr(tokenizer, "eos_ids", ()) or ())
    specials |= {getattr(tokenizer, "bos_id", -1),
                 getattr(tokenizer, "pad_id", -1)}
    if isinstance(tokenizer, ByteTokenizer):
        for i in range(ByteTokenizer.SPECIALS, min(vocab_size, 259)):
            out[i] = bytes([i - ByteTokenizer.SPECIALS])
        return out
    for i in range(min(vocab_size, tokenizer.vocab_size)):
        if i in specials:
            continue
        text = tokenizer.decode([i])
        if not text or "�" in text:
            continue
        out[i] = text.encode("utf-8")
    return out


@dataclasses.dataclass
class TokenFSM:
    """One compiled grammar variant (frozen numpy; device upload and
    host stepping both read these arrays)."""

    tok_class: np.ndarray     # [vocab] int32
    class_next: np.ndarray    # [n_states, n_classes] int32
    class_ok: np.ndarray      # [n_states, n_classes] bool
    accept: np.ndarray        # [n_states] bool
    forced_tok: np.ndarray    # [n_states] int32 (-1 = not forced)
    forced_eos: np.ndarray    # [n_states] bool (only-EOS accept state)
    eos_ids: tuple
    grammar_hash: str
    vocab_size: int

    @property
    def n_states(self) -> int:
        return int(self.class_next.shape[0])

    @property
    def n_classes(self) -> int:
        return int(self.class_next.shape[1])

    # ------------------------------------------------------ host stepping

    def allowed(self, state: int) -> np.ndarray:
        """[vocab] bool mask of legal token ids from ``state`` (the
        admission first-token mask)."""
        return self.class_ok[state][self.tok_class]

    def advance(self, state: int, tok: int) -> int:
        return int(self.class_next[state, self.tok_class[tok]])

    def run(self, ids: Sequence[int], state: int = START) -> int:
        for t in ids:
            state = int(self.class_next[state, self.tok_class[t]])
            if state == DEAD:
                return DEAD
        return state

    def in_grammar(self, ids: Sequence[int]) -> bool:
        """Every step legal from START (EOS-terminated or not) — the
        test-suite oracle for "no off-grammar token was ever emitted"."""
        state = START
        for t in ids:
            if not self.class_ok[state, self.tok_class[t]]:
                return False
            state = int(self.class_next[state, self.tok_class[t]])
        return True

    def forced_run(self, state: int, cap: int) -> tuple:
        """Longest forced chain from ``state``: token ids where each
        step has exactly one legal token, capped at ``cap``. Returns
        ``(run, ends_eos, end_state)`` — ``ends_eos`` means the state
        after the run admits ONLY EOS, i.e. the command is complete and
        the scheduler can finish the request without decoding at all."""
        run: List[int] = []
        while len(run) < cap:
            if self.forced_eos[state]:
                return run, True, state
            t = int(self.forced_tok[state])
            if t < 0:
                break
            run.append(t)
            state = int(self.class_next[state, self.tok_class[t]])
        return run, bool(self.forced_eos[state]), state


def compile_token_fsm(dfa: CharDFA, tokenizer: Tokenizer,
                      vocab_size: int, eos_ids: Sequence[int],
                      _block: int = 4096) -> TokenFSM:
    """Compose the byte DFA with a tokenizer into a :class:`TokenFSM`.

    The dest matrix is computed blockwise-vectorized: token byte
    strings padded to ``[B, L]``, then L gather steps of ``[B, S]``
    through the byte-transition table — ~1k numpy ops for a 256k vocab
    instead of 1.5M Python-level walks. Columns are then interned
    (``tobytes`` keys) into equivalence classes.
    """
    S = dfa.n_states
    eos_ids = tuple(sorted(set(int(e) for e in eos_ids)))
    byte_table = token_byte_table(tokenizer, vocab_size)

    # Dead class (index 0 by convention): specials / out-of-vocab /
    # unrepresentable tokens — next == DEAD from every state.
    dead_col = np.zeros((S,), np.int32)
    classes: dict = {dead_col.tobytes(): 0}
    reps: List[np.ndarray] = [dead_col]
    tok_class = np.zeros((vocab_size,), np.int32)

    ids = [i for i, bs in enumerate(byte_table) if bs is not None]
    for lo in range(0, len(ids), _block):
        chunk = ids[lo:lo + _block]
        maxlen = max(len(byte_table[i]) for i in chunk)
        bt = np.zeros((len(chunk), maxlen), np.int64)
        ln = np.zeros((len(chunk),), np.int64)
        for j, i in enumerate(chunk):
            bs = byte_table[i]
            bt[j, :len(bs)] = np.frombuffer(bs, np.uint8)
            ln[j] = len(bs)
        cur = np.broadcast_to(np.arange(S, dtype=np.int32),
                              (len(chunk), S)).copy()
        for pos in range(maxlen):
            stepped = dfa.next[cur, bt[:, pos][:, None]]
            active = (pos < ln)[:, None]
            cur = np.where(active, stepped, cur)
        for j, i in enumerate(chunk):
            key = cur[j].tobytes()
            cls = classes.get(key)
            if cls is None:
                cls = len(reps)
                classes[key] = cls
                reps.append(cur[j].astype(np.int32))
            tok_class[i] = cls

    # EOS: its own class — next stays in place (the engine's eos_mask
    # terminates the slot; a frozen slot repeating its carry token must
    # not be able to walk the FSM into DEAD), legal exactly where the
    # char DFA accepts.
    eos_cls = len(reps)
    reps.append(np.arange(S, dtype=np.int32))
    for e in eos_ids:
        if 0 <= e < vocab_size:
            tok_class[e] = eos_cls

    C = len(reps)
    class_next = np.stack(reps, axis=1).astype(np.int32)   # [S, C]
    class_ok = class_next != DEAD
    class_ok[:, 0] = False
    class_ok[:, eos_cls] = dfa.accept
    class_next[:, 0] = DEAD
    class_ok[DEAD, :] = False
    class_next[DEAD, :] = DEAD

    # Forced chains: a state with exactly one legal TOKEN (not class —
    # a legal class holding several tokens is a choice, not a force).
    cls_size = np.bincount(tok_class, minlength=C)
    eos_only = np.zeros((S,), bool)
    forced = np.full((S,), -1, np.int32)
    for s in range(S):
        legal = np.nonzero(class_ok[s])[0]
        if legal.size != 1:
            continue     # several classes (or none) — a choice point
        cls = int(legal[0])
        if cls == eos_cls:
            eos_only[s] = True
        elif cls_size[cls] == 1:
            forced[s] = int(np.nonzero(tok_class == cls)[0][0])
    return TokenFSM(
        tok_class=tok_class,
        class_next=class_next,
        class_ok=class_ok,
        accept=dfa.accept.copy(),
        forced_tok=forced,
        forced_eos=eos_only,
        eos_ids=eos_ids,
        grammar_hash=dfa.grammar_hash,
        vocab_size=vocab_size,
    )


def compile_permissive_fsm(vocab_size: int,
                           eos_ids: Sequence[int]) -> TokenFSM:
    """The mask-everything variant ("permissive" profile): two states
    (DEAD, START), every in-vocab token legal and self-looping. The A/B
    instrument — full grammar *plumbing* (mask gathers, state word,
    forced-run checks) with the unconstrained language, so constrained
    vs unconstrained transcripts must be byte-identical."""
    eos_ids = tuple(sorted(set(int(e) for e in eos_ids)))
    tok_class = np.ones((vocab_size,), np.int32)
    class_next = np.array([[DEAD, DEAD], [DEAD, START]], np.int32)
    class_ok = np.array([[False, False], [False, True]])
    return TokenFSM(
        tok_class=tok_class,
        class_next=class_next,
        class_ok=class_ok,
        accept=np.array([False, True]),
        forced_tok=np.full((2,), -1, np.int32),
        forced_eos=np.zeros((2,), bool),
        eos_ids=eos_ids,
        grammar_hash="permissive",
        vocab_size=vocab_size,
    )
