"""Text normalizers for scoring transcripts (a copy of the JAX package's)."""

from .basic import BasicTextNormalizer  # noqa: F401
from .english import EnglishTextNormalizer  # noqa: F401
