"""Tokenizers for the local engine.

Two implementations behind one duck-typed interface:

- :class:`ByteTokenizer` — zero-asset UTF-8 byte tokenizer (vocab 256 + special
  ids) with a llama-style chat template. Works in any environment, drives the
  CI path and the synthetic bench models.
- :class:`HFTokenizer` — wraps a transformers tokenizer loaded from a LOCAL
  path (zero-egress environments cannot download), for real Llama checkpoints.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence


class ByteTokenizer:
    """UTF-8 bytes + special tokens. ids 0..255 = bytes; 256=bos, 257=eos/eot, 258=pad."""

    vocab_size = 512  # headroom so models can round vocab up for MXU tiling
    is_byte_level = True  # token id == byte value: grammar constraints apply

    bos_id = 256
    eos_id = 257
    pad_id = 258

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def token_bytes(self, token_id: int) -> bytes:
        """The token's RAW UTF-8 bytes (OpenAI logprobs ``bytes`` semantics:
        concatenating entries reproduces the text's bytes — a per-token decode
        would turn partial UTF-8 into replacement-char bytes instead).
        Specials contribute no text."""
        return bytes([token_id]) if 0 <= token_id < 256 else b""

    def apply_chat_template(
        self, messages: List[Dict[str, str]], add_generation_prompt: bool = True
    ) -> List[int]:
        """<|bos|><role>\\ncontent<|eot|>... + assistant header."""
        ids: List[int] = [self.bos_id]
        for message in messages:
            role = str(message.get("role", "user"))
            content = str(message.get("content", ""))
            ids += self.encode(f"<{role}>\n") + self.encode(content) + [self.eos_id]
        if add_generation_prompt:
            ids += self.encode("<assistant>\n")
        return ids

    @property
    def stop_ids(self) -> List[int]:
        return [self.eos_id]


class HFTokenizer:
    """transformers tokenizer from a local directory (e.g. a Llama-3 checkpoint)."""

    is_byte_level = False  # BPE merges: byte-level grammar masks don't apply

    def __init__(self, path: str):
        if not os.path.isdir(path):
            raise FileNotFoundError(f"tokenizer path {path!r} is not a directory")
        from transformers import AutoTokenizer  # local import; heavy

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)
        self.bos_id = self._tok.bos_token_id
        self.eos_id = self._tok.eos_token_id
        self.pad_id = self._tok.pad_token_id if self._tok.pad_token_id is not None else self.eos_id

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        return ([self.bos_id] + ids) if (add_bos and self.bos_id is not None) else ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def token_bytes(self, token_id: int) -> bytes:
        """Raw bytes of one token (OpenAI logprobs ``bytes`` semantics). For
        byte-level BPE vocabularies (GPT-2/Llama-3 style) the token string is
        mapped back through the bytes↔unicode alphabet so partial UTF-8
        sequences keep their true bytes; other vocabularies (SentencePiece)
        fall back to the decoded text's bytes."""
        if token_id in (self.bos_id, self.eos_id, self.pad_id):
            return b""
        tok_str = self._tok.convert_ids_to_tokens(int(token_id))
        if tok_str is None:
            return b""
        if getattr(self, "_byte_decoder", None) is None:
            try:
                from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode

                self._byte_decoder = {c: b for b, c in bytes_to_unicode().items()}
            except Exception:  # tokenization_gpt2 moved/absent: fallback only
                self._byte_decoder = {}
        bd = self._byte_decoder
        if bd and all(c in bd for c in tok_str):
            return bytes(bd[c] for c in tok_str)
        # SentencePiece fallback: the raw piece carries '▁' (U+2581)
        # word-boundary markers where the text has spaces. decode([id]) strips
        # a leading space from a lone piece, so concatenating per-token bytes
        # would drop every inter-word space — map the marker directly instead.
        if "▁" in tok_str:
            return tok_str.replace("▁", " ").encode("utf-8")
        return self.decode([token_id]).encode("utf-8")

    def apply_chat_template(
        self, messages: List[Dict[str, str]], add_generation_prompt: bool = True
    ) -> List[int]:
        if getattr(self._tok, "chat_template", None) is None:
            # Checkpoint dirs without a chat template (base models) get a
            # minimal llama-style layout instead of a hard error — same
            # structure as ByteTokenizer.apply_chat_template: every turn ends
            # with the stop token so multi-turn boundaries are marked.
            eot = self.stop_ids[-1]
            ids: List[int] = [self.bos_id] if self.bos_id is not None else []
            for m in messages:
                ids += self.encode(f"<{m.get('role', 'user')}>\n{m.get('content', '')}")
                ids.append(eot)
            if add_generation_prompt:
                ids += self.encode("<assistant>\n")
            return ids
        return self._tok.apply_chat_template(
            messages, add_generation_prompt=add_generation_prompt, tokenize=True
        )

    @property
    def stop_ids(self) -> List[int]:
        ids = [self.eos_id]
        # llama-3 chat end-of-turn
        eot = self._tok.convert_tokens_to_ids("<|eot_id|>")
        if isinstance(eot, int) and eot >= 0 and eot != self._tok.unk_token_id:
            ids.append(eot)
        return ids


def get_tokenizer(tokenizer_path: Optional[str] = None):
    if tokenizer_path:
        return HFTokenizer(tokenizer_path)
    return ByteTokenizer()
