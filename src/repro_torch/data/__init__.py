"""The port's data pipeline (a numpy copy of `repro/data/`)."""

from .pipeline import DataConfig, MemmapCorpus, SyntheticLM, make_source

__all__ = ["DataConfig", "MemmapCorpus", "SyntheticLM", "make_source"]
