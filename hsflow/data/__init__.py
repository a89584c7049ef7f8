from hsflow.data.synthetic import (
    synthetic_pair,
    synthetic_sequence,
    translation_pair,
)

__all__ = ["synthetic_pair", "synthetic_sequence", "translation_pair"]
