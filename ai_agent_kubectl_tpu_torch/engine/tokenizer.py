"""Tokenizer layer.

The reference had no tokenizer (tokenization happened inside OpenAI's
service, SURVEY.md §2.2). Two implementations behind one interface:

- ``HFTokenizer``  — wraps a HuggingFace ``tokenizers`` fast tokenizer file
  (tokenizer.json) for real checkpoints (Gemma/Llama/Mixtral).
- ``ByteTokenizer`` — deterministic UTF-8 byte-level fallback for tests and
  the toy models: token = byte + 3, specials pad=0/bos=1/eos=2. No files,
  no network, fully reversible.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Protocol, Sequence


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int
    eos_ids: tuple
    pad_id: int

    def encode(self, text: str, *, add_bos: bool = True) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes + 3 special tokens. vocab = 259."""

    SPECIALS = 3

    def __init__(self, pad_id: int = 0, bos_id: int = 1, eos_id: int = 2):
        self.pad_id = pad_id
        self.bos_id = bos_id
        self.eos_ids = (eos_id,)
        self.vocab_size = 256 + self.SPECIALS

    def encode(self, text: str, *, add_bos: bool = True) -> List[int]:
        ids = [b + self.SPECIALS for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        # Ignore specials and out-of-byte-range ids (toy vocabs may be
        # larger than 259; a random-init model can emit any id).
        data = bytes(
            i - self.SPECIALS
            for i in ids
            if self.SPECIALS <= i < 256 + self.SPECIALS
        )
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """HuggingFace fast-tokenizer file (tokenizer.json)."""

    def __init__(self, path: str | Path, bos_id: int, eos_ids: tuple, pad_id: int):
        from tokenizers import Tokenizer as _Tok

        self._tok = _Tok.from_file(str(path))
        self.vocab_size = self._tok.get_vocab_size()
        self.bos_id = bos_id
        self.eos_ids = tuple(eos_ids)
        self.pad_id = pad_id

    def encode(self, text: str, *, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        specials = set(self.eos_ids) | {self.bos_id, self.pad_id}
        return self._tok.decode([i for i in ids if i not in specials])


class StreamDecoder:
    """Incremental detokenization with UTF-8 hold-back.

    A token can end mid-way through a multi-byte UTF-8 character, where
    ``decode()`` shows U+FFFD; trailing replacement chars are held back
    until the next token resolves them, so streamed pieces concatenate to
    exactly the final text with no transient mojibake. Genuinely invalid
    bytes (still U+FFFD after 3 more chars arrive) are released by
    ``push``; ``flush`` emits any held-back tail at end of stream.

    Decoding is incremental via a sliding prefix window (the scheme TGI and
    vLLM use): only ids from ``_prefix_idx`` on are re-decoded per push, and
    the newly-emitted piece is the *difference* between that window's decode
    with and without the unemitted tail. Because both decodes share the same
    window start, tokenizer behaviours that depend on sequence position
    (SentencePiece ``Strip(left)``, byte-fallback fusing) cancel out of the
    diff — chunk decodes are never naively concatenated. The window advances
    whenever its text is fully emitted, so per-push cost is independent of
    generation length.
    """

    #: Force-release threshold: a window this long that still ends in
    #: held-back U+FFFD is a garbage run, not a split character — emit it
    #: so per-push cost stays bounded even on adversarial byte streams.
    _WINDOW_CAP = 64

    def __init__(self, tokenizer: Tokenizer):
        self._tokenizer = tokenizer
        self.ids: List[int] = []
        self.text = ""
        self._prefix_idx = 0    # window start: left context for the decode
        self._read_idx = 0      # ids before this are fully emitted
        self._win_emitted = 0   # chars emitted beyond the prefix decode

    def _window(self) -> tuple:
        """(chars already emitted in window coordinates, window decode)."""
        prefix_text = self._tokenizer.decode(
            self.ids[self._prefix_idx:self._read_idx]
        )
        new_text = self._tokenizer.decode(self.ids[self._prefix_idx:])
        return len(prefix_text) + self._win_emitted, new_text

    def _advance(self) -> None:
        self._prefix_idx = self._read_idx
        self._read_idx = len(self.ids)
        self._win_emitted = 0

    def push(self, *new_ids: int) -> Optional[str]:
        """Add token ids; return the newly-stable text piece (or None)."""
        self.ids.extend(new_ids)
        base, new_text = self._window()
        stable = len(new_text)
        while (stable > base and new_text[stable - 1] == "�"
               and len(new_text) - stable < 3):
            stable -= 1
        if (stable < len(new_text)
                and len(self.ids) - self._prefix_idx > self._WINDOW_CAP):
            return self._force_release(base)
        piece = None
        emitted_to = base
        if stable > base:
            piece = new_text[base:stable]
            self.text += piece
            self._win_emitted += stable - base
            emitted_to = stable
        if emitted_to == len(new_text):
            self._advance()
        return piece

    def _force_release(self, base: int) -> Optional[str]:
        """Window overflow with a held-back tail: release the window, but
        advance only to the last id boundary whose decode is
        replacement-free — a split UTF-8 sequence still pending completion
        keeps its ids in the next window (advancing through it would make
        the next window's prefix decode disagree with the full decode and
        duplicate/drop characters). If no boundary in the unemitted tail is
        clean, the run is genuine garbage: release everything."""
        end = len(self.ids)
        j = None
        for cand in range(end, self._read_idx, -1):
            t = self._tokenizer.decode(self.ids[self._prefix_idx:cand])
            if not t.endswith("�"):
                j = cand
                break
        if j is None:
            j = end
            t = self._tokenizer.decode(self.ids[self._prefix_idx:])
        piece = t[base:] or None
        if piece:
            self.text += piece
        self._prefix_idx = j
        self._read_idx = j
        self._win_emitted = 0
        return piece

    def flush(self) -> Optional[str]:
        """Emit any held-back tail (end of stream)."""
        base, new_text = self._window()
        if len(new_text) > base:
            piece = new_text[base:]
            self.text += piece
            self._advance()
            return piece
        return None


def load_tokenizer(model_cfg, tokenizer_path: Optional[str]) -> Tokenizer:
    """Pick the tokenizer for a model config: HF file when provided/found,
    byte-level for toy models."""
    if tokenizer_path:
        p = Path(tokenizer_path)
        if p.is_dir():
            p = p / "tokenizer.json"
        return HFTokenizer(p, model_cfg.bos_id, model_cfg.eos_ids, model_cfg.pad_id)
    if model_cfg.name.startswith("toy"):
        return ByteTokenizer()
    raise FileNotFoundError(
        f"No TOKENIZER_PATH configured for model {model_cfg.name!r} "
        "(set TOKENIZER_PATH to a tokenizer.json or checkpoint dir)"
    )
