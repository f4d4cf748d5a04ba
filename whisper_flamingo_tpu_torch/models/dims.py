"""Model dimension records and the Whisper size registry.

A copy of ``whisper_flamingo_tpu/models/dims.py``: the port imports
nothing of the JAX package. ``ModelDimensions`` has the OpenAI field
names, so the ``dims`` dict of an OpenAI ``.pt`` checkpoint loads
directly; the size table is the public Whisper family.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class ModelDimensions:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_head: int
    n_text_state: int
    n_text_layer: int

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        """99 for v1/v2 vocabs, 100 for large-v3 (<|yue|>); the single
        source of truth for the tokenizer's language count — validation
        tokenization must never drift from decode tokenization."""
        return self.n_vocab - 51765 - int(self.is_multilingual)

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ModelDimensions":
        return ModelDimensions(**{k: int(v) for k, v in d.items()})


def _dims(state: int, head: int, layer: int, *, n_vocab: int, n_mels: int = 80) -> ModelDimensions:
    return ModelDimensions(
        n_mels=n_mels,
        n_audio_ctx=1500,
        n_audio_state=state,
        n_audio_head=head,
        n_audio_layer=layer,
        n_vocab=n_vocab,
        n_text_ctx=448,
        n_text_head=head,
        n_text_state=state,
        n_text_layer=layer,
    )


_MULTI = 51865  # multilingual vocab (v1/v2)
_EN = 51864  # English-only vocab
_V3 = 51866  # large-v3 adds <|yue|>

MODEL_DIMS = {
    "tiny": _dims(384, 6, 4, n_vocab=_MULTI),
    "tiny.en": _dims(384, 6, 4, n_vocab=_EN),
    "base": _dims(512, 8, 6, n_vocab=_MULTI),
    "base.en": _dims(512, 8, 6, n_vocab=_EN),
    "small": _dims(768, 12, 12, n_vocab=_MULTI),
    "small.en": _dims(768, 12, 12, n_vocab=_EN),
    "medium": _dims(1024, 16, 24, n_vocab=_MULTI),
    "medium.en": _dims(1024, 16, 24, n_vocab=_EN),
    # "large" is an alias for large-v3, matching the registry URL and the
    # upstream OpenAI whisper package
    "large": _dims(1280, 20, 32, n_vocab=_V3, n_mels=128),
    "large-v1": _dims(1280, 20, 32, n_vocab=_MULTI),
    "large-v2": _dims(1280, 20, 32, n_vocab=_MULTI),
    "large-v3": _dims(1280, 20, 32, n_vocab=_V3, n_mels=128),
    # test-scale dims (not a reference size; used for unit tests / dry runs)
    "debug": ModelDimensions(
        n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
        n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_head=2,
        n_text_state=64, n_text_layer=2,
    ),
}

available_models = tuple(k for k in MODEL_DIMS if k != "debug")
